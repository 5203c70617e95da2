"""Rules of the PyTorch port: it never imports JAX or the JAX package, its
entry points default to the GPU and refuse to fall back to the CPU, and
``chip_smoke.py`` fails without a card before allocating anything."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"

torch.set_num_threads(2)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno


SERVING_FEATURES = ("prefix_cache.py", "speculative.py", "kv_spill.py")
# the front door's control and observability plane, and session migration
CONTROL_PLANE = ("observability/__init__.py", "observability/metrics.py",
                 "observability/tracing.py", "observability/attribution.py",
                 "observability/flight_recorder.py",
                 "observability/sentinel.py", "observability/catalog.py",
                 "distributed/watchdog.py", "inference/migration.py",
                 "serving/slo.py")
# the router, the fleet supervisor and the digest sketch
FLEET_STACK = ("router/__init__.py", "router/__main__.py", "router/replica.py",
               "router/journal.py", "router/quarantine.py",
               "router/placement.py", "router/server.py",
               "controlplane/__init__.py", "controlplane/sketch.py",
               "fleet/__init__.py", "fleet/__main__.py", "fleet/breaker.py",
               "fleet/chaos.py", "fleet/supervisor.py")


# the Paddle-API training path: framework core, nn, optimizers, amp,
# ResNet and the fused layers; Model with its callbacks and summary, the
# metrics, the data pipeline over the native ring, save / load; the fused
# functional ops, the MoE layer and its gates, the quantization API; the
# recurrent layers, beam search and nn.utils; the regularizers, the
# row-sparse gradients, LookAhead / ModelAverage, the numerics debugging
# tools and the memory tools
PADDLE_API = ("device/__init__.py", "dtypes.py", "core/random.py",
              "core/tensor.py", "core/amp_state.py", "autograd/__init__.py",
              "ops/__init__.py", "ops/creation.py", "ops/manipulation.py",
              "ops/linalg.py", "ops/math.py", "ops/random_ops.py",
              "nn/__init__.py", "nn/layer.py", "nn/initializer.py",
              "nn/clip.py", "nn/functional.py", "optimizer/__init__.py",
              "optimizer/lr.py", "amp/__init__.py", "vision/models/resnet.py",
              "incubate/nn/__init__.py", "incubate/nn/functional.py",
              "hapi/__init__.py", "hapi/model.py", "hapi/callbacks.py",
              "hapi/summary.py", "metric/__init__.py", "io/__init__.py",
              "io/native_loader.py", "io/mp_loader.py",
              "framework/__init__.py", "framework/io.py",
              "native/__init__.py", "incubate/__init__.py",
              "incubate/distributed/__init__.py",
              "incubate/distributed/models/__init__.py",
              "incubate/distributed/models/moe/__init__.py",
              "incubate/distributed/models/moe/gate.py",
              "incubate/distributed/models/moe/moe_layer.py",
              "quantization/__init__.py", "nn/rnn.py", "nn/decode.py",
              "nn/utils.py", "ops/_prim.py", "ops/_generated.py",
              "ops/indexing.py", "ops/search.py", "ops/extras.py",
              "ops/compat.py", "ops/array.py", "linalg.py", "errors.py",
              "regularizer.py", "core/selected_rows.py",
              "incubate/optimizer.py", "amp/debugging.py",
              "device/memory_debug.py")


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert PORT / "kernels" / "primitives.py" in files
    assert {PORT / "inference" / f for f in SERVING_FEATURES} <= set(files)
    assert {PORT / f for f in CONTROL_PLANE} <= set(files)
    assert {PORT / f for f in FLEET_STACK} <= set(files)
    assert {PORT / f for f in PADDLE_API} <= set(files)
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad


# One interpreter imports the port's stacks in turn and reports, after each,
# the modules it has loaded; then it runs the training entry point as ``python
# -m`` does, with no --device, and ``chip_smoke.py`` as ``python3
# chip_smoke.py`` does.  The tests below read that report.
_STACKS = (
    ("nn_functional", ("paddle_tpu_torch.nn", "paddle_tpu_torch.nn.functional")),
    ("serving", ("paddle_tpu_torch.serving.server",
                 "paddle_tpu_torch.serving.__main__",
                 "paddle_tpu_torch.inference",
                 "paddle_tpu_torch.inference.prefix_cache",
                 "paddle_tpu_torch.inference.speculative",
                 "paddle_tpu_torch.inference.kv_spill",
                 "paddle_tpu_torch.inference.migration",
                 "paddle_tpu_torch.serving.slo",
                 "paddle_tpu_torch.observability",
                 "paddle_tpu_torch.observability.catalog",
                 "paddle_tpu_torch.observability.flight_recorder",
                 "paddle_tpu_torch.observability.sentinel",
                 "paddle_tpu_torch.distributed.watchdog")),
    ("fleet", ("paddle_tpu_torch.router", "paddle_tpu_torch.router.__main__",
               "paddle_tpu_torch.controlplane",
               "paddle_tpu_torch.controlplane.sketch",
               "paddle_tpu_torch.fleet", "paddle_tpu_torch.fleet.__main__")),
    ("training", ("paddle_tpu_torch.models.pretrain",
                  "paddle_tpu_torch.models.gpt",
                  "paddle_tpu_torch.models.dit",
                  "paddle_tpu_torch.kernels.flash_attention",
                  "paddle_tpu_torch.profile_step")),
    ("paddle_api", tuple("paddle_tpu_torch." + f[:-3].replace(
        "/__init__", "").replace("/", ".") for f in PADDLE_API)),
)
_REPORT = """
import contextlib, importlib, io, json, runpy, sys
stacks, report, before = json.loads(sys.argv[1]), {}, set(sys.modules)
for name, modules in stacks:
    for m in modules:
        importlib.import_module(m)
    report[name] = sorted(set(sys.modules) - before)
    before = set(sys.modules)
def run(argv, main):
    sys.argv = argv
    out, err, code = io.StringIO(), io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    except Exception as e:
        code, _ = 1, err.write(repr(e))
    return {"exit": code, "stdout": out.getvalue(), "stderr": err.getvalue()}
report["entry_point"] = run(
    ["pretrain", "--preset", "tiny", "--steps", "1"],
    lambda: runpy.run_module("paddle_tpu_torch.models.pretrain",
                             run_name="__main__"))
report["chip_smoke"] = run(
    ["chip_smoke.py"], lambda: runpy.run_path("chip_smoke.py",
                                              run_name="__main__"))
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def stack_report():
    r = subprocess.run([sys.executable, "-c", _REPORT, json.dumps(_STACKS)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stderr
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(report) == [name for name, _ in _STACKS] + ["entry_point",
                                                             "chip_smoke"]
    return report


def _loaded_no_jax(report, upto):
    """The modules loaded by the stacks up to ``upto`` hold neither JAX nor
    the JAX package (each stack's own modules are among them)."""
    names = [n for n, _ in _STACKS]
    loaded = [m for n in names[:names.index(upto) + 1] for m in report[n]]
    stack = dict(_STACKS)[upto]
    assert set(stack) <= set(loaded), (upto, stack)
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib",
                                                     "paddle_tpu")]
    assert not bad, bad


def test_importing_the_serving_stack_loads_no_jax(stack_report):
    _loaded_no_jax(stack_report, "serving")


def test_importing_the_fleet_stack_loads_no_jax(stack_report):
    _loaded_no_jax(stack_report, "fleet")


def test_fleet_spawns_port_replicas_on_the_card_by_default(monkeypatch):
    """A process replica is ``python -m paddle_tpu_torch.serving`` (never
    the JAX package's launcher), and the fleet launcher asks every replica
    for the card unless told otherwise."""
    from paddle_tpu_torch.fleet import ProcessReplicaHandle, supervisor
    from paddle_tpu_torch.fleet.__main__ import (build_parser,
                                                 replica_launch_args)
    seen = []

    class Popen:
        def __init__(self, argv):
            seen.append(argv)

    monkeypatch.setattr(supervisor.subprocess, "Popen", Popen)
    args = build_parser().parse_args([])
    assert args.device == "cuda"
    ProcessReplicaHandle("fs0", "127.0.0.1", 8001,
                         launch_args=replica_launch_args(args)).spawn()
    argv = seen[0]
    assert argv[1:3] == ["-m", "paddle_tpu_torch.serving"]
    assert argv[argv.index("--device") + 1] == "cuda"
    assert not any(a == "paddle_tpu.serving" for a in argv)


def test_unported_control_plane_asks_raise(monkeypatch):
    """The multi-router control plane runs: ``RouterServer(controlplane=)``
    builds a router that joins the ring, the router launcher's ``--store``
    and the fleet launcher's ``--routers 2`` reach their serving loops
    (stubbed here: the router's loop records its arguments, the fleet's
    router listener stops at once, its router slot spawns no process);
    ``--tensor-parallel 2`` is forwarded to every replica's launcher."""
    import asyncio
    import signal

    from paddle_tpu_torch.controlplane import (LocalStore,
                                               ProcessRouterHandle,
                                               RouterControlPlane)
    from paddle_tpu_torch.fleet.__main__ import main as fleet_main
    from paddle_tpu_torch.router import RouterServer
    from paddle_tpu_torch.router import server as router_server
    from paddle_tpu_torch.router.__main__ import main as router_main
    router = RouterServer([], allow_empty=True, health_interval_s=1e9,
                          controlplane=RouterControlPlane("rt0",
                                                          LocalStore()))
    asyncio.run(router.cp_tick())
    cp = router.statusz()["controlplane"]
    assert (cp["router_id"], cp["members"]) == ("rt0", ["rt0"])
    seen = {}

    def route_forever(replicas, **kw):
        seen["router"] = kw

    monkeypatch.setattr(router_server, "route_forever", route_forever)
    assert router_main(["--store", "127.0.0.1:9000",
                        "--router-id", "rt3"]) == 0
    assert seen["router"]["controlplane"].rid == "rt3"
    assert seen["router"]["discover_replicas"]

    async def start_http(self, host, port):
        seen["fleet"] = self.cp.rid
        raise KeyboardInterrupt

    monkeypatch.setattr(RouterServer, "start_http", start_http)
    monkeypatch.setattr(ProcessRouterHandle, "spawn",
                        lambda self: seen.setdefault("slot", self.id))
    old = signal.getsignal(signal.SIGTERM)
    try:
        assert fleet_main(["--routers", "2", "--replicas", "0",
                           "--min-replicas", "0", "--device", "cpu"]) == 0
    finally:
        signal.signal(signal.SIGTERM, old)
    assert (seen["fleet"], seen["slot"]) == ("rt0", "rt1")
    from paddle_tpu_torch.fleet.__main__ import (build_parser,
                                                 replica_launch_args)
    launch = replica_launch_args(build_parser().parse_args(
        ["--tensor-parallel", "2", "--device", "cpu"]))
    at = launch.index("--tensor-parallel")
    assert launch[at + 1] == "2"

    async def stop_at_once(self, host, port):
        raise KeyboardInterrupt

    monkeypatch.setattr(RouterServer, "start_http", stop_at_once)
    try:
        assert fleet_main(["--tensor-parallel", "2", "--replicas", "0",
                           "--min-replicas", "0", "--device", "cpu"]) == 0
    finally:
        signal.signal(signal.SIGTERM, old)


def test_importing_the_training_stack_loads_no_jax(stack_report):
    _loaded_no_jax(stack_report, "training")


def test_importing_the_paddle_api_loads_no_jax(stack_report):
    _loaded_no_jax(stack_report, "paddle_api")


def test_paddle_api_defaults_to_the_card():
    """Layers, ``to_tensor``, the creation ops and the optimizers' layers
    go to the device ``set_device`` chose, by default the card: with no
    GPU they raise rather than carry on on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.vision.models import resnet18
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    old = device._current[0]
    device._current[0] = None
    try:
        for make in (lambda: paddle.nn.Linear(2, 2),
                     lambda: paddle.nn.BatchNorm2D(2),
                     lambda: inn.FusedTransformerEncoderLayer(8, 2, 16),
                     lambda: resnet18(num_classes=2),
                     lambda: paddle.to_tensor([1.0]),
                     lambda: paddle.zeros([2]), lambda: paddle.randn([2]),
                     lambda: paddle.set_device("gpu")):
            with pytest.raises(RuntimeError, match="cuda"):
                make()
    finally:
        device._current[0] = old


def test_model_and_data_loader_default_to_the_card(tmp_path):
    """``Model``'s steps, the ``DataLoader``'s batches and ``paddle.load``
    put their tensors on the device ``set_device`` chose, by default the
    card: with no GPU they raise rather than run on the CPU."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    old = device._current[0]
    paddle.set_device("cpu")
    net = paddle.nn.Linear(4, 2)
    model = paddle.Model(net).prepare(
        paddle.optimizer.SGD(0.1, parameters=net.parameters()),
        paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    paddle.save({"w": torch.ones(2)}, str(tmp_path / "w.pd"))
    data = [(np.ones(4, np.float32), np.int64(1))] * 4
    device._current[0] = None
    try:
        for run in (lambda: model.train_batch([np.ones((2, 4), np.float32)],
                                              [np.ones(2, np.int64)]),
                    lambda: model.fit(data, batch_size=2, verbose=0),
                    lambda: model.predict_batch([np.ones((2, 4),
                                                         np.float32)]),
                    lambda: next(iter(paddle.io.DataLoader(data,
                                                           batch_size=2))),
                    lambda: list(paddle.io.DataLoader(data, batch_size=2,
                                                      num_workers=2)),
                    lambda: paddle.load(str(tmp_path / "w.pd")),
                    lambda: paddle.summary(net, (1, 4))):
            with pytest.raises(RuntimeError, match="cuda"):
                run()
        assert all(p.device.type == "cpu" for p in net.parameters())
    finally:
        device._current[0] = old


def test_ring_library_builds_beside_the_kernels_not_in_the_package():
    """``native/ringbuf.cc`` (the reference's, byte for byte) builds with
    g++ into ``build/paddle_tpu_torch_kernels/`` with its source-hash
    stamp; nothing is built inside the package."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.kernels._build import BUILD_DIR
    assert native.load_library() is not None
    lib = Path(native.library_path())
    assert lib.parent == BUILD_DIR == ROOT / "build" / \
        "paddle_tpu_torch_kernels"
    assert lib.exists() and Path(str(lib) + ".srchash").exists()
    built = [p for p in PORT.rglob("*") if p.suffix in (".so", ".o") or
             p.name == "build"]
    assert not built, built
    assert (PORT / "native" / "ringbuf.cc").read_bytes() == \
        (ROOT / "paddle_tpu" / "native" / "ringbuf.cc").read_bytes()


def test_fused_attention_never_takes_the_plain_path_at_flash_shapes(
        monkeypatch):
    """At s 512, head dim 64 (no mask, no attention dropout) the fused
    attention calls the flash entry; on a tensor that is neither on the
    CPU nor on a card that call raises (the plain einsum-softmax, which
    meta tensors would run, is never taken), and a CPU tensor reaches the
    flash kernels' plain version.  At s 128 it takes the plain path."""
    from paddle_tpu_torch import device
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.kernels import flash_attention as fa
    old = device._current[0]
    device.set_device("cpu")
    try:
        layer = inn.FusedMultiHeadAttention(128, 2, dropout_rate=0.0,
                                            attn_dropout_rate=0.0)
    finally:
        device._current[0] = old
    plain = []
    real = fa._reference_attention_lse
    monkeypatch.setattr(fa, "_reference_attention_lse",
                        lambda *a, **k: plain.append(1) or real(*a, **k))
    with torch.no_grad():
        layer(torch.zeros(1, 512, 128))
        assert plain == [1]
        layer(torch.zeros(1, 128, 128))
        assert plain == [1]
        torch.nn.Module.to(layer, "meta")
        with pytest.raises(NotImplementedError, match="flash"):
            layer(torch.empty(1, 512, 128, device="meta"))
        assert layer(torch.empty(1, 128, 128, device="meta")).is_meta


def test_default_device_is_cuda_and_raises_without_gpu():
    """Entry points run on the card unless the caller asks for the CPU:
    with no GPU the default raises instead of carrying on on the CPU."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            LlamaGenerator)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaGenerator(model)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    from paddle_tpu_torch.serving.__main__ import build_engine, build_parser
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine(build_parser().parse_args([]))
    from paddle_tpu_torch.models import pretrain
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain.PretrainStep(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain.build_trainer(pretrain.build_parser().parse_args(
            ["--preset", "tiny"]))
    from paddle_tpu_torch.models import dit, gpt
    for make in (lambda: gpt.GPTForCausalLM(gpt.GPTConfig.tiny()),
                 lambda: dit.DiT(dit.DiTConfig.tiny()),
                 lambda: dit.DiTTrainStep(dit.DiTConfig.tiny()),
                 lambda: dit.build_trainer(dit.build_parser().parse_args(
                     ["--preset", "tiny"]))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_serving_features_default_to_the_card():
    """The engine with the prefix cache, speculative decoding and the spill
    tier on (arguments or launcher options) still defaults to the card and
    raises without one; on the CPU the spill ring is plain host memory."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving.__main__ import build_engine, build_parser
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    on = dict(prefix_cache=True, spec_decode="ngram", kv_spill_pages=4)
    eng = ContinuousBatchingEngine(model, device="cpu", max_seq_len=32, **on)
    assert eng.g.device.type == "cpu" and not eng.spill._ring[0].is_pinned()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(model, **on)
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine(build_parser().parse_args(["--prefix-cache"]))


# the kernel wrappers and the engine's device steps: a launch sits in no
# try block, so a failed launch surfaces instead of falling back
_LAUNCHES = {"ragged_paged_attention", "paged_attention",
             "write_kv_pages_all_layers",
             "write_kv_pages_all_layers_quantized", "gmm", "tgmm",
             "_grouped_ffn", "_moe_ffn", "_forward_tokens", "_step_fn",
             "_spec_verify_fn", "_fused_decode_fn", "_dispatch_spec",
             "_cow_copy_pages", "step", "flash_attention",
             "_patch_attention"}


def test_no_try_around_a_launch():
    """No try block in the serving modules (the engine, the allocator, the
    prefix cache, speculative decoding, the spill tier, the launcher) or in
    the control and observability plane (session migration, the SLO
    controller, the registry, tracer, attribution, flight recorder,
    sentinel and catalog, the step watchdog) or in the models (the DiT
    attention routes by shape, never by catching a kernel's refusal) or in
    the Paddle-API path (the fused attention's flash call) wraps a kernel
    launch or an engine step."""
    files = [PORT / "inference" / f for f in
             ("generation.py", "kv_cache.py") + SERVING_FEATURES] + \
        [PORT / "serving" / "__main__.py"] + \
        [PORT / f for f in CONTROL_PLANE] + \
        [PORT / "models" / f for f in ("llama.py", "pretrain.py", "gpt.py",
                                       "dit.py")] + \
        [PORT / f for f in PADDLE_API]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if not isinstance(node, ast.Try):
                continue
            for sub in ast.walk(ast.Module(body=node.body, type_ignores=[])):
                if isinstance(sub, ast.Call):
                    fn = sub.func
                    name = fn.attr if isinstance(fn, ast.Attribute) else \
                        getattr(fn, "id", None)
                    if name in _LAUNCHES:
                        bad.append(f"{f.relative_to(ROOT)}:{sub.lineno} "
                                   f"{name}")
    assert not bad, bad


def test_training_entry_point_defaults_to_the_card(stack_report):
    """``python -m paddle_tpu_torch.models.pretrain`` with no --device
    refuses to run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    r = stack_report["entry_point"]
    assert r["exit"] != 0 and "cuda" in r["stderr"]
    assert '"loss"' not in r["stdout"]


def test_model_and_engine_devices_must_agree():
    from paddle_tpu_torch.inference import LlamaGenerator
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert LlamaGenerator(model, device="cpu", max_seq_len=32).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LlamaGenerator(model, device="cuda")


def test_cuda_only_paths_refuse_cpu_fallback():
    """Flash attention, the grouped matmuls and the weight-only matmul take
    their plain versions only for a CPU tensor: a tensor on any other
    device launches a kernel or raises, forward and backward alike (checked
    through the dispatch on the device type; the CUDA launches are
    tests/test_torch_cuda_kernels.py's)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    meta = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match="flash"):
        fa.flash_attention(meta, meta, meta, causal=True)
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(NotImplementedError, match="flash"):
        fa.flash_backward(meta, meta, meta, meta, lse, meta, True)
    # the grouped matmuls likewise, forward and backward modes
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    x = torch.empty((16, 64), device="meta")
    w = torch.empty((2, 64, 64), device="meta")
    tg = torch.zeros((2,), dtype=torch.int32, device="meta")
    for call in (lambda: gm.gmm(x, w, tg, bm=8),
                 lambda: gm.gmm(x, w, tg, bm=8, trans_rhs=True),
                 lambda: gm.tgmm(x, x, tg, 2, bm=8)):
        with pytest.raises(ValueError, match="device"):
            call()
    # the weight-only matmul and the linear over it, int8 and int4
    from paddle_tpu_torch.kernels import weight_only as wo
    from paddle_tpu_torch.quantization import weight_only_linear
    xq = torch.empty((4, 64), device="meta")
    q8 = torch.empty((64, 32), dtype=torch.int8, device="meta")
    q4 = torch.empty((32, 32), dtype=torch.int8, device="meta")
    s = torch.empty((32,), device="meta")
    for call in (lambda: wo.weight_only_matmul(xq, q8, s),
                 lambda: wo.weight_only_matmul(xq, q4, s, int4_rows=64),
                 lambda: weight_only_linear(xq, q8, weight_scale=s),
                 lambda: weight_only_linear(xq, q4, weight_scale=s,
                                            weight_dtype="int4")):
        with pytest.raises(ValueError, match="device"):
            call()


def test_new_routes_refuse_cpu_fallback(monkeypatch):
    """The gmm and tgmm sm90 routes (bf16), the attention split route (T x
    group <= 16) and sm90 route (bf16 prefill), the primitive matmul's
    "sm90" route and the weight-only matmul's "narrow" and "wide" routes
    take their plain versions only for CPU tensors: on a meta tensor each
    raises before any plain version runs, as the other routes do."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import paged_attention as pa

    def plain(*args, **kw):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(gm, "_gmm_reference", plain)
    monkeypatch.setattr(gm, "_tgmm_reference", plain)
    monkeypatch.setattr(pa, "_reference_ragged_paged_attention", plain)
    bf = dict(device="meta", dtype=torch.bfloat16)
    x, w = torch.empty((256, 64), **bf), torch.empty((2, 64, 128), **bf)
    for bm in (16, 128):                       # narrow and wide forms
        tg = torch.zeros((256 // bm,), dtype=torch.int32, device="meta")
        assert gm._route(x.dtype) == "sm90"
        for trans in (False, True):
            with pytest.raises(ValueError, match="device"):
                gm.gmm(x, w.transpose(1, 2) if trans else w, tg, bm=bm,
                       trans_rhs=trans)
        # tgmm, plain and with its fused gather and scale (cp.async and
        # TMA operands alike)
        y = torch.empty((256, 128), **bf)
        rows = torch.zeros((256,), dtype=torch.int32, device="meta")
        s = torch.empty((256,), **bf)
        for kw in ({}, {"lhs_rows": rows}, {"rhs_rows": rows,
                                            "rhs_scale": s}):
            with pytest.raises(ValueError, match="device"):
                gm.tgmm(x, y, tg, 2, bm=bm, **kw)
    # the primitive matmul's "sm90" route (bf16 and fp16) and the
    # weight-only matmul's "narrow" and "wide" routes, int8 and int4
    from paddle_tpu_torch.kernels import primitives as P
    from paddle_tpu_torch.kernels import weight_only as wo
    monkeypatch.setattr(P, "_matmul_reference", plain)
    monkeypatch.setattr(wo, "_wo_reference", plain)
    for dt in (torch.bfloat16, torch.float16):
        xm = torch.empty((256, 64), device="meta", dtype=dt)
        wm = torch.empty((64, 128), device="meta", dtype=dt)
        assert P._matmul_route(xm, wm) == "sm90"
        with pytest.raises(ValueError, match="device"):
            P.matmul_kernel()(xm, wm)
    q8 = torch.empty((64, 128), dtype=torch.int8, device="meta")
    q4 = torch.empty((32, 128), dtype=torch.int8, device="meta")
    s = torch.empty((128,), device="meta")
    for m, route in ((8, "narrow"), (100, "wide")):
        xq = torch.empty((m, 64), **bf)
        assert wo._route(xq, q8, 64, 128) == route
        with pytest.raises(ValueError, match="device"):
            wo.weight_only_matmul(xq, q8, s)
        with pytest.raises(ValueError, match="device"):
            wo.weight_only_matmul(xq, q4, s, int4_rows=64)
    bt = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    ctx = torch.zeros((3,), dtype=torch.int32, device="meta")
    for T, dt, route in ((1, torch.bfloat16, "split"),
                         (4, torch.bfloat16, "split"),
                         (64, torch.bfloat16, "sm90"),
                         (64, torch.float32, "tile")):
        kc = torch.empty((2, 8, 16, 64), device="meta", dtype=dt)
        q = torch.empty((3, T, 8, 64), device="meta", dtype=dt)
        assert pa.launch_plan(q, kc, bt)["route"] == route
        with pytest.raises(ValueError, match="device"):
            pa.ragged_paged_attention(q, kc, kc, bt, ctx)
        with pytest.raises(ValueError, match="device"):
            pa.ragged_paged_attention(q, kc, kc, bt, ctx,
                                      k_scale=torch.empty((2, 8),
                                                          device="meta"),
                                      v_scale=torch.empty((2, 8),
                                                          device="meta"))


def test_kv_commits_read_nothing_back():
    """The engine step's KV commits (float and int8 pools) read no tensor
    back to the host: they run on meta tensors, where any host read (an
    ``.item()``, or indexing by a 0-d tensor) raises.  On the card such a
    read syncs the stream every step."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    L, kvh, P, page, d, B, T = 2, 2, 5, 4, 8, 2, 3
    meta = dict(device="meta")
    i32 = dict(device="meta", dtype=torch.int32)
    kc = torch.empty((L, kvh, P, page, d), **meta)
    rows = torch.empty((L, B * T, kvh, d), **meta)
    pa.write_kv_pages_all_layers(kc, kc.clone(), rows, rows.clone(),
                                 torch.empty((B * T,), **i32))
    kq = torch.empty((L, kvh, P + 1, page, d), dtype=torch.int8,
                     device="meta")
    sc = torch.empty((L, kvh, P + 1), **meta)
    pa.write_kv_pages_all_layers_quantized(
        kq, kq.clone(), sc, sc.clone(), rows, rows.clone(),
        torch.empty((B,), **i32), torch.empty((B,), **i32),
        torch.empty((B, 4), **i32), 16)


def test_primitives_refuse_cpu_fallback():
    """The primitive generators take their plain versions only for CPU
    tensors: a meta tensor raises, and so does a function with no CUDA body
    on any tensor that is not on the CPU (the CUDA launches are
    tests/test_torch_cuda_kernels.py's)."""
    from paddle_tpu_torch.kernels import primitives as P
    x = torch.empty((8, 32), device="meta")
    full = {"elementwise": P.KernelFn(lambda a, b: a * b, "return a * b;"),
            "reduce": P.KernelFn(torch.add, "return a + b;"),
            "matmul": P.KernelFn(lambda a: a * 2, "return a * 2.0f;")}
    plain = {k: P.KernelFn(f.torch) for k, f in full.items()}
    calls = {"elementwise": lambda fn: P.elementwise_kernel(fn)(x, x),
             "reduce": lambda fn: P.reduce_kernel(fn, 0.0)(x),
             "matmul": lambda fn: P.matmul_kernel(epilogue=fn)(x, x.T)}
    for kind, call in calls.items():
        with pytest.raises(ValueError, match="device"):
            call(full[kind])
        with pytest.raises(ValueError, match="CUDA body"):
            call(plain[kind])
    # a bare callable is a function with no CUDA body
    with pytest.raises(ValueError, match="CUDA body"):
        P.elementwise_kernel(lambda a: a)(x)
    # matmul with no epilogue has one (the identity), so it reaches the
    # device check
    with pytest.raises(ValueError, match="device"):
        P.matmul_kernel()(x, x.T)
    # and a CPU tensor still runs the plain version
    xc = torch.ones((2, 3))
    assert torch.equal(P.elementwise_kernel(lambda a: a + 1)(xc), xc + 1)


def test_importing_nn_functional_loads_no_jax(stack_report):
    _loaded_no_jax(stack_report, "nn_functional")


def test_flash_modes_refuse_cpu_fallback(monkeypatch):
    """Masked, dropout and varlen calls (and nn.functional's flash ops) on a
    tensor that is neither on the CPU nor on a card raise, and never reach
    a plain version."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels import flash_attention as fa
    reached = []

    def plain(*args, **kw):
        reached.append(args)
        raise AssertionError("the plain version ran")

    for name in ("_reference_attention_lse", "_flash_bwd_dq",
                 "_flash_bwd_dkv"):
        monkeypatch.setattr(fa, name, plain)
    x = torch.empty((1, 64, 2, 64), device="meta")
    mask = torch.empty((1, 1, 64, 64), device="meta")
    cu = torch.tensor([0, 30, 64], dtype=torch.int32, device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    seed = torch.zeros((1,), dtype=torch.int32, device="meta")
    F = nn.functional
    for call in (
            lambda: fa.flash_attention(x, x, x, causal=True, attn_mask=mask),
            lambda: fa.flash_attention(x, x, x, dropout=0.1),
            lambda: fa.flash_attention(x, x, x, attn_mask=mask, dropout=0.5),
            lambda: fa.flash_attn_varlen(x[0], x[0], x[0], cu, cu),
            lambda: fa.flash_backward(x, x, x, x, lse, x, False, mask=mask,
                                      drop_p=0.1, seed=seed),
            lambda: F.flash_attention(x, x, x, dropout=0.1, causal=True),
            lambda: F.flash_attn_qkvpacked(torch.stack([x, x, x], 2)),
            lambda: F.flash_attn_varlen_qkvpacked(
                torch.stack([x[0]] * 3, 1), cu, cu)):
        with pytest.raises(NotImplementedError, match="flash"):
            call()
    # the causal varlen's eager packing check cannot read meta values
    with pytest.raises(NotImplementedError):
        fa.flash_attn_varlen(x[0], x[0], x[0], cu, cu, causal=True)
    assert not reached


def test_chip_smoke_fails_without_a_card(tmp_path, stack_report):
    """No CPU fallback: without CUDA the script exits non-zero and prints
    no result (run as ``__main__`` in the report's interpreter); alone in a
    directory (no package) it cannot pass either."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, PYTHONPATH="")
    r = stack_report["chip_smoke"]
    assert r["exit"] != 0
    assert '"ok": true' not in r["stdout"]
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=60, env=env)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
