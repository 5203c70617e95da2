"""The port's recurrent layers (``nn/rnn.py``), beam search
(``nn/decode.py``), the Transformer decoder and ``nn/utils.py`` against
the JAX package, on the CPU, and the slice as a whole at a small size.

Layers are built in both packages and the reference's state is carried
into the port (``_pair``).  ``SEQ_LAYERS`` holds one case a configuration:
numpy inputs from a seed go forward and backward through both, every float
output leaf (outputs and final states) and every input and parameter
gradient held within ``TOL`` of the tensor's largest value; the
reference's passes are its jitted arithmetic, all cases in one
``jax.jit`` of ``jax.vjp`` (``seq_refs``).  The slice as a whole: a 2+2
layer ``Transformer`` (d 32) trains 3 steps under label smoothing,
``Adam`` and ``NoamDecay``; a 2-layer LSTM language model trains 3 steps
with ``SGD`` and global-norm clipping; ``dynamic_decode`` over its cells
gives the reference's ids, scores and lengths (a near-tie, where the
port's k-th and (k+1)-th totals lie within ``NEAR_TIE`` relative, would
excuse a different choice from that step on).  Each reference step is a
jitted ``value_and_grad`` of ``functional_call`` and the reference
optimizer's own step.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as T
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import optimizer as topt

from test_torch_nn_layers import _close, _cpu, _pair, _x

torch.set_num_threads(2)

TOL = 2e-5
TRAIN_TOL = 1e-4          # 3 optimizer steps: fp32 sums in other orders
NEAR_TIE = 1e-5
NOISE = 1e-6              # a gradient entry below this is rounding noise


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _swap(layer, params):
    """Set the reference layer's parameters to ``params``; returns the old
    arrays."""
    named = dict(layer.named_parameters())
    saved = {k: p._data for k, p in named.items()}
    for k, a in params.items():
        named[k]._data = a
    return saved


def _stack_cell(nn, c1, c2):
    """Two LSTM cells as one cell, ``cell(x, [s1, s2])``, over either
    package's ``Layer``."""
    class StackCell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.c1, self.c2 = c1, c2

        def forward(self, x, states):
            h1, s1 = self.c1(x, states[0])
            h2, s2 = self.c2(h1, states[1])
            return h2, [s1, s2]
    return StackCell()


def _seq(r, *lens):
    return np.array(lens, np.int64)


def _ids(r, b, t, v):
    return r.integers(0, v, (b, t))


def _mask(n):
    return np.where(np.tril(np.ones((n, n), bool)), 0.0,
                    -1e9).astype(np.float32)


# name -> (make(nn), inputs(rng), call(layer, *inputs) -> output tree)
SEQ_LAYERS = {
    "simple_rnn_cell": (
        lambda nn: nn.SimpleRNNCell(4, 6, activation="relu"),
        lambda r: [_x(3, 4, seed=1), _x(3, 6, seed=2)],
        lambda m, x, h: m(x, h)),
    "lstm_cell": (lambda nn: nn.LSTMCell(4, 6),
                  lambda r: [_x(3, 4, seed=1), _x(3, 6, seed=2),
                             _x(3, 6, seed=3)],
                  lambda m, x, h, c: m(x, (h, c))),
    "gru_cell_no_bias": (lambda nn: nn.GRUCell(4, 6, bias_ih_attr=False,
                                               bias_hh_attr=False),
                         lambda r: [_x(3, 4, seed=1)], lambda m, x: m(x)),
    "rnn_lstm_lengths": (
        lambda nn: nn.RNN(nn.LSTMCell(4, 6)),
        lambda r: [_x(3, 5, 4, seed=1), _seq(r, 5, 2, 4)],
        lambda m, x, s: m(x, sequence_length=s)),
    "rnn_gru_reverse_time_major": (
        lambda nn: nn.RNN(nn.GRUCell(4, 6), is_reverse=True,
                          time_major=True),
        lambda r: [_x(5, 3, 4, seed=1), _x(3, 6, seed=2)],
        lambda m, x, h: m(x, h)),
    "rnn_custom_cell_lengths": (
        lambda nn: nn.RNN(_stack_cell(nn, nn.LSTMCell(4, 6),
                                      nn.LSTMCell(6, 6))),
        lambda r: [_x(3, 5, 4, seed=1), _seq(r, 5, 1, 4)],
        lambda m, x, s: m(x, [m.cell.c1.get_initial_states(x[:, 0]),
                              m.cell.c2.get_initial_states(x[:, 0])],
                          sequence_length=s)),
    "birnn_lstm_lengths": (
        lambda nn: nn.BiRNN(nn.LSTMCell(4, 6), nn.LSTMCell(4, 6)),
        lambda r: [_x(3, 5, 4, seed=1), _seq(r, 5, 3, 1)],
        lambda m, x, s: m(x, sequence_length=s)),
    "simple_rnn_relu_2_layers": (
        lambda nn: nn.SimpleRNN(4, 6, num_layers=2, activation="relu"),
        lambda r: [_x(2, 5, 4, seed=1)], lambda m, x: m(x)),
    "lstm_2_layers_bidirect_lengths": (
        lambda nn: nn.LSTM(4, 6, num_layers=2, direction="bidirect"),
        lambda r: [_x(3, 5, 4, seed=1), _seq(r, 5, 4, 2)],
        lambda m, x, s: m(x, sequence_length=s)),
    "gru_lengths_initial_states": (
        lambda nn: nn.GRU(4, 6, num_layers=2),
        lambda r: [_x(3, 5, 4, seed=1), _x(2, 3, 6, seed=2),
                   _seq(r, 5, 2, 4)],
        lambda m, x, h, s: m(x, h, sequence_length=s)),
    "lstm_time_major_states": (
        lambda nn: nn.LSTM(4, 6, time_major=True),
        lambda r: [_x(5, 2, 4, seed=1), _x(1, 2, 6, seed=2),
                   _x(1, 2, 6, seed=3)],
        lambda m, x, h, c: m(x, (h, c))),
    "decoder_layer_post_norm": (
        lambda nn: nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0),
        lambda r: [_x(2, 5, 8, seed=1), _x(2, 6, 8, seed=2), _mask(5)],
        lambda m, t, mem, msk: m(t, mem, tgt_mask=msk)),
    "decoder_layer_pre_norm_gelu": (
        lambda nn: nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0,
                                              activation="gelu",
                                              normalize_before=True),
        lambda r: [_x(2, 5, 8, seed=1), _x(2, 6, 8, seed=2),
                   np.where(r.random((2, 1, 5, 6)) < 0.2, -1e9, 0.0)
                   .astype(np.float32)],
        lambda m, t, mem, msk: m(t, mem, memory_mask=msk)),
    "decoder": (
        lambda nn: nn.TransformerDecoder(
            nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0), 2,
            norm=nn.LayerNorm(8)),
        lambda r: [_x(2, 5, 8, seed=1), _x(2, 6, 8, seed=2), _mask(5)],
        lambda m, t, mem, msk: m(t, mem, tgt_mask=msk)),
    "transformer_pre_norm": (
        lambda nn: nn.Transformer(8, 2, 1, 1, 16, dropout=0.0,
                                  normalize_before=True),
        lambda r: [_x(2, 6, 8, seed=1), _x(2, 5, 8, seed=2), _mask(5)],
        lambda m, s, t, msk: m(s, t, tgt_mask=msk)),
}


def _seq_inputs(case):
    return SEQ_LAYERS[case][1](np.random.default_rng(
        sorted(SEQ_LAYERS).index(case)))


def _cots(leaves):
    return [np.random.default_rng(20 + i).standard_normal(np.shape(o))
            .astype(np.float32) for i, o in enumerate(leaves)]


@pytest.fixture(scope="module")
def seq_pairs():
    with _cpu():
        return {case: _pair(make) for case, (make, _, _) in
                SEQ_LAYERS.items()}


@pytest.fixture(scope="module")
def seq_refs(seq_pairs):
    """Every case's reference pass in one jit: (float output leaves,
    input gradients, parameter gradients)."""
    def one(j, call, inputs, params, floats):
        fl = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]

        def f(params, floats):
            xs = [JT(a) for a in inputs]
            for i, a in zip(fl, floats):
                xs[i] = JT(a)
            saved = _swap(j, params)
            try:
                out = call(j, *xs)
            finally:
                _swap(j, saved)
            return tuple(o._data for o in _leaves(out))
        out, vjp = jax.vjp(f, params, floats)
        gp, gx = vjp(tuple(_cots(out)))
        return out, gx, gp

    cases = {c: (seq_pairs[c][0], SEQ_LAYERS[c][2], _seq_inputs(c))
             for c in SEQ_LAYERS}

    def run(all_params, all_floats):
        return {c: one(j, call, inputs, all_params[c], all_floats[c])
                for c, (j, call, inputs) in cases.items()}
    params = {c: {n: p._data for n, p in j.named_parameters()}
              for c, (j, _, _) in cases.items()}
    floats = {c: [a for a in inputs if a.dtype.kind == "f"]
              for c, (_, _, inputs) in cases.items()}
    res = jax.jit(run)(params, floats)
    return {c: ([np.asarray(o) for o in out], [np.asarray(g) for g in gx],
                {n: np.asarray(g) for n, g in gp.items()})
            for c, (out, gx, gp) in res.items()}


@pytest.mark.parametrize("case", sorted(SEQ_LAYERS))
def test_sequence_layers(case, seq_pairs, seq_refs):
    t = seq_pairs[case][1]
    xs = [torch.tensor(a, requires_grad=a.dtype.kind == "f")
          for a in _seq_inputs(case)]
    outs = _leaves(SEQ_LAYERS[case][2](t, *xs))
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, _cots(outs))) \
        .backward()
    want_out, want_gx, want_gp = seq_refs[case]
    assert len(outs) == len(want_out)
    for i, (o, w) in enumerate(zip(outs, want_out)):
        _close(o, w, TOL, f"out {i}")
    for i, (x, w) in enumerate(zip([x for x in xs if x.requires_grad],
                                   want_gx)):
        _close(x.grad, w, TOL, f"input grad {i}")
    assert set(want_gp) == {n for n, _ in t.named_parameters()}
    for n, p in t.named_parameters():
        _close(p.grad, want_gp[n], TOL, f"grad {n}")


def test_lengths_freeze_states_and_zero_outputs():
    """Past its length a row's output is 0 and its final state is the one
    at its length, in both directions."""
    T.seed(0)
    m = tnn.LSTM(3, 4, direction="bidirect")
    x = torch.tensor(_x(2, 6, 3))
    y, (h, c) = m(x, sequence_length=torch.tensor([6, 2]))
    assert not y[1, 2:].any() and y[1, :2].abs().min() > 0
    y2, (h2, c2) = m(x[1:, :2])
    _close(y[1, :2], y2[0].detach().numpy())
    _close(h[:, 1], h2[:, 0].detach().numpy())
    _close(c[:, 1], c2[:, 0].detach().numpy())


def test_rnn_dropout_between_layers_and_initial_states():
    T.seed(1)
    m = tnn.GRU(3, 4, num_layers=3, dropout=0.5)
    x = torch.tensor(_x(2, 5, 3))
    m.eval()
    a = m(x)[0]
    assert torch.equal(a, m(x)[0])
    m.train()
    assert not torch.equal(m(x)[0], a)
    cell = tnn.LSTMCell(3, 4)
    h, c = cell.get_initial_states(x[:, 0], init_value=0.5)
    assert h.shape == (2, 4) and (c == 0.5).all() and h.dtype == x.dtype


# ---------------- nn.utils ----------------

def test_weight_norm_and_its_removal():
    j, t = _pair(lambda nn: nn.Linear(5, 3))
    jnn.utils.weight_norm(j, dim=1)
    tnn.utils.weight_norm(t, dim=1)
    js = {k: np.asarray(v._data) for k, v in j.state_dict().items()}
    assert list(t.state_dict()) == list(js) == ["bias", "weight_g",
                                                "weight_v"]
    t.set_state_dict({k: v * 1.5 if k == "weight_g" else v
                      for k, v in js.items()})
    j.set_state_dict({k: JT(v * 1.5 if k == "weight_g" else v)
                      for k, v in js.items()})
    x = _x(4, 5)
    tx = torch.tensor(x, requires_grad=True)
    out = t(tx)
    _close(out, j(JT(x)).numpy())
    out.sum().backward()
    assert t.weight_g.grad is not None and t.weight_v.grad is not None
    jnn.utils.remove_weight_norm(j)
    tnn.utils.remove_weight_norm(t)
    assert list(t.state_dict()) == ["bias", "weight"]
    _close(t.weight, np.asarray(j.weight._data))


def test_spectral_norm_power_iteration():
    """The power iteration's vectors start from the reference's (its draw
    is its own) and both refine them once a call."""
    j, t = _pair(lambda nn: nn.Linear(6, 4))
    jnn.utils.spectral_norm(j, n_power_iterations=2)
    tnn.utils.spectral_norm(t, n_power_iterations=2)
    js = {k: np.asarray(v._data) for k, v in j.state_dict().items()}
    assert sorted(t.state_dict()) == sorted(js)
    t.set_state_dict(js)
    x = _x(3, 6)
    for _ in range(2):
        _close(t(torch.tensor(x)), j(JT(x)).numpy())
        _close(t.weight_u, np.asarray(j.weight_u._data))
        _close(t.weight_v, np.asarray(j.weight_v._data))


def test_vectors_and_gradient_clips():
    j, t = _pair(lambda nn: nn.Linear(4, 3))
    vec = tnn.utils.parameters_to_vector(t.parameters())
    _close(vec, jnn.utils.parameters_to_vector(j.parameters()).numpy())
    tnn.utils.vector_to_parameters(vec * 2, t.parameters())
    _close(t.weight, 2 * np.asarray(j.weight._data))
    for clip in ("norm", "norm_inf", "value"):
        grads = [_x(4, 3, seed=5) * 3, _x(3, seed=6) * 3]
        for p, g in zip(j.parameters(), grads):
            p.grad = JT(g)
        for p, g in zip(t.parameters(), grads):
            p.grad = torch.tensor(g)
        if clip == "value":
            jnn.utils.clip_grad_value_(j.parameters(), 0.5)
            tnn.utils.clip_grad_value_(t.parameters(), 0.5)
        else:
            nt = float("inf") if clip == "norm_inf" else 2.0
            jt = jnn.utils.clip_grad_norm_(j.parameters(), 1.5, nt)
            tt = tnn.utils.clip_grad_norm_(t.parameters(), 1.5, nt)
            _close(tt, jt.numpy())
        for pj, pt in zip(j.parameters(), t.parameters()):
            _close(pt.grad, np.asarray(pj.grad._data), what=clip)
    t.weight.grad = torch.full((4, 3), float("nan"))
    before = tobs.device_syncs()
    with pytest.raises(RuntimeError):
        tnn.utils.clip_grad_norm_(t.parameters(), 1.0,
                                  error_if_nonfinite=True)
    assert tobs.device_syncs() == before + 1


# ---------------- the slice as a whole ----------------

def _sinusoid(n, d):
    pos = np.arange(n)[:, None]
    i = np.arange(d)[None, :]
    ang = pos / np.power(10000.0, 2 * (i // 2) / d)
    return np.where(i % 2 == 0, np.sin(ang), np.cos(ang)).astype(np.float32)


def _seq2seq(nn, vocab, d, layers, ffn, heads, length):
    """Source and target Embeddings over one vocabulary, sinusoidal
    positions (a non-persistable buffer), ``nn.Transformer`` and a Linear
    to the vocabulary: the model of ``chip_smoke.py``'s ``seq_models``."""
    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embed = nn.Embedding(vocab, d)
            self.tgt_embed = nn.Embedding(vocab, d)
            self.transformer = nn.Transformer(d, heads, layers, layers, ffn,
                                              dropout=0.0)
            self.head = nn.Linear(d, vocab)
            pos = _sinusoid(length, d)
            self.register_buffer("pos", JT(pos) if nn is jnn else
                                 torch.tensor(pos), persistable=False)
            self.scale = d ** 0.5

        def forward(self, src, tgt, tgt_mask):
            s = self.src_embed(src) * self.scale + self.pos[:src.shape[1]]
            t = self.tgt_embed(tgt) * self.scale + self.pos[:tgt.shape[1]]
            return self.head(self.transformer(s, t, tgt_mask=tgt_mask))
    return Seq2Seq()


def _smoothed_loss(F, logits, labels, vocab):
    soft = F.label_smooth(F.one_hot(labels, vocab), epsilon=0.1)
    return F.softmax_with_cross_entropy(logits, soft, soft_label=True).mean()


def _lstm_lm(nn, vocab, hidden, layers):
    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, hidden)
            self.rnn = nn.LSTM(hidden, hidden, num_layers=layers)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, ids):
            return self.head(self.rnn(self.embed(ids))[0])
    return LM()


def _train_both(j, t, jopt_, topt_, loss_of, batches, sched=(),
                resync=False):
    """Steps in both packages, one a batch: the reference's loss and
    gradients from one jitted ``value_and_grad`` of its forward, then each
    optimizer's step.  With ``resync`` each step starts the port from the
    reference's parameters, and after it every gradient and every
    parameter entry whose reference gradient has been at least NOISE at
    each step so far is held within TRAIN_TOL (``_resync_checks``).
    Returns the losses of both and the entries left out with a nonzero
    gradient (an entry with a zero gradient, such as an embedding row no
    batch reads, moves by 0 in both)."""
    jf = jax.jit(jax.value_and_grad(lambda params, *xs: loss_of(
        "ref", j, params, *xs)))
    jl, tl, live, noise = [], [], {}, {}
    for xs in batches:
        if resync:
            t.set_state_dict({n: np.asarray(p._data)
                              for n, p in j.named_parameters()})
        params = {n: p._data for n, p in j.named_parameters()}
        loss, grads = jf(params, *xs)
        for n, p in j.named_parameters():
            p.grad = JT(grads[n])
        lt = loss_of("port", t, None, *[torch.tensor(a) for a in xs])
        lt.backward()
        if resync:
            for n, p in t.named_parameters():
                g = np.asarray(grads[n])
                _close(p.grad, g, TRAIN_TOL, f"grad {n}")
                live[n] = live.get(n, True) & (np.abs(g) >= NOISE)
                noise[n] = noise.get(n, False) | ((g != 0) &
                                                  (np.abs(g) < NOISE))
        jopt_.step()
        jopt_.clear_grad()
        topt_.step()
        topt_.clear_grad()
        for sch in sched:
            sch.step()
        if resync:
            jp = dict(j.named_parameters())
            for n, p in t.named_parameters():
                m = live[n]
                _close(p.detach().numpy()[m], np.asarray(jp[n]._data)[m],
                       TRAIN_TOL, f"param {n}")
        jl.append(float(loss))
        tl.append(float(lt))
    return jl, tl, sum(int(v.sum()) for v in noise.values())


def _assert_same_params(j, t, tol):
    js = dict(j.named_parameters())
    for n, p in t.named_parameters():
        _close(p, np.asarray(js[n]._data), tol, n)


def test_transformer_trains_with_label_smoothing_adam_noam():
    """Adam's first updates are about lr x sign(grad), so an entry whose
    gradient is rounding noise (the attention's key biases: softmax ignores
    a shift common to every key) moves 2 x lr apart, and the runs then
    drift apart over steps.  So each step starts the port from the
    reference's parameters (the moments are each package's own, made from
    gradients that agree), and entries whose gradient fell below NOISE
    are left out of the parameter check: the key biases and a few more,
    under 5% of the parameters."""
    # vocabulary and FFN at d: fewer distinct shapes for the reference's
    # eager initializers and optimizer to compile
    V, d, S = 32, 32, 7
    make = lambda nn: _seq2seq(nn, V, d, 2, d, 2, 8)  # noqa: E731
    j, t = _pair(make)
    js = jopt.lr.NoamDecay(d, 4)
    ts = topt.lr.NoamDecay(d, 4)
    jo = jopt.Adam(js, 0.9, 0.98, 1e-9, parameters=j.parameters())
    to = topt.Adam(ts, 0.9, 0.98, 1e-9, parameters=t.parameters())
    mask = _mask(S - 1)

    def loss_of(pkg, m, params, src, tgt):
        if pkg == "ref":
            saved = _swap(m, params)
            try:
                logits = m(JT(src), JT(tgt[:, :-1]), JT(mask))
                return _smoothed_loss(jnn.functional, logits,
                                      JT(tgt[:, 1:]), V)._data
            finally:
                _swap(m, saved)
        logits = m(src, tgt[:, :-1], torch.tensor(mask))
        return _smoothed_loss(tnn.functional, logits, tgt[:, 1:], V)

    r = np.random.default_rng(0)
    batches = [(_ids(r, 3, 6, V), _ids(r, 3, S, V)) for _ in range(3)]
    jl, tl, left_out = _train_both(j, t, jo, to, loss_of, batches,
                                   [js, ts], resync=True)
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_TOL)
    n = sum(p.numel() for p in t.parameters())
    assert left_out < 0.05 * n, (left_out, n)
    assert to.get_lr() == jo.get_lr()
    gen = t.transformer.generate_square_subsequent_mask(4)
    ref = j.transformer.generate_square_subsequent_mask(4).numpy()
    assert gen.dtype == torch.float32
    np.testing.assert_array_equal(gen.numpy(), ref)


@pytest.fixture(scope="module")
def lm_pair():
    with _cpu():
        return _pair(lambda nn: _lstm_lm(nn, 64, 16, 2))


def test_lstm_lm_trains_with_sgd_and_global_norm_clip(lm_pair):
    j, t = lm_pair
    jo = jopt.SGD(1.0, parameters=j.parameters(),
                  grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    to = topt.SGD(1.0, parameters=t.parameters(),
                  grad_clip=tnn.ClipGradByGlobalNorm(0.5))

    def loss_of(pkg, m, params, ids, labels):
        if pkg == "ref":
            saved = _swap(m, params)
            try:
                return jnn.functional.cross_entropy(
                    m(JT(ids)).reshape([-1, 64]), JT(labels.reshape(-1))
                )._data
            finally:
                _swap(m, saved)
        return tnn.functional.cross_entropy(m(ids).reshape([-1, 64]),
                                            labels.reshape(-1))

    r = np.random.default_rng(1)
    batches = [(_ids(r, 4, 9, 64), _ids(r, 4, 9, 64)) for _ in range(3)]
    jl, tl, _ = _train_both(j, t, jo, to, loss_of, batches)
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_TOL)
    assert tl[-1] < tl[0]
    _assert_same_params(j, t, TRAIN_TOL)


class _Recording(tnn.BeamSearchDecoder):
    """The port's decoder, recording each step's top ``beam + 1`` totals
    (the near-tie margins)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.margins = []

    def _select(self, total):
        vals = torch.topk(total, self.beam_size + 1, dim=-1).values
        self.margins.append(vals)
        return super()._select(total)


def _near_ties(margins, k):
    """Steps at which some row's k-th and (k+1)-th totals lie within
    NEAR_TIE relative."""
    return [s for s, v in enumerate(margins)
            if bool(((v[:, k - 1] - v[:, k]).abs() <=
                     NEAR_TIE * v[:, k - 1].abs()).any())]


def test_dynamic_decode_over_the_lm(lm_pair):
    j, t = lm_pair
    B, W, H, end = 2, 3, 16, 7
    # make the end token likely, so some beams finish
    for m in (j, t):
        with torch.no_grad():
            if m is t:
                m.head.bias[end] += 2.5
            else:
                m.head.bias._data = m.head.bias._data.at[end].add(2.5)
    jdec = jnn.BeamSearchDecoder(
        _stack_cell(jnn, j.rnn.cells[0], j.rnn.cells[1]), 1, end, W,
        embedding_fn=j.embed, output_fn=j.head)
    tdec = _Recording(_stack_cell(tnn, t.rnn.cells[0], t.rnn.cells[1]), 1,
                      end, W, embedding_fn=t.embed, output_fn=t.head)
    zeros = np.zeros((B, H), np.float32)
    jinit = [(JT(zeros), JT(zeros)), (JT(zeros), JT(zeros))]
    tinit = [(torch.tensor(zeros), torch.tensor(zeros))] * 2
    jids, jscores, jlens = jnn.dynamic_decode(jdec, jinit, max_step_num=6,
                                              return_length=True)
    before = tobs.device_syncs()
    with torch.no_grad():
        tids, tscores, tlens = tnn.dynamic_decode(
            tdec, tinit, max_step_num=6, return_length=True)
    steps = tids.shape[-1]
    assert tobs.device_syncs() - before == min(steps + 1, 6)
    assert not _near_ties(tdec.margins, W), "a near-tie in this draw"
    assert tids.dtype == torch.int32 and tlens.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), jids.numpy())
    np.testing.assert_array_equal(tlens.numpy(), jlens.numpy())
    _close(tscores, jscores.numpy(), TOL)
    assert (tlens < steps).any()


# ---------------- the surface ----------------

# Item 17.3b (ROADMAP.md): the spatial half of the reference's nn, the one
# part of its surface the port lacks.
MISSING_17_3B = {
    "nn": {
        "AdaptiveAvgPool1D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
        "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AvgPool1D", "AvgPool3D",
        "BatchNorm3D", "ChannelShuffle", "Conv1D", "Conv1DTranspose",
        "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "Fold",
        "FractionalMaxPool2D", "FractionalMaxPool3D", "GroupNorm",
        "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "LPPool1D",
        "LPPool2D", "LocalResponseNorm", "MaxPool1D", "MaxPool3D",
        "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "Pad1D", "Pad2D",
        "Pad3D", "PixelShuffle", "PixelUnshuffle", "SpectralNorm",
        "SyncBatchNorm", "Unfold", "Upsample", "UpsamplingBilinear2D",
        "UpsamplingNearest2D", "ZeroPad1D", "ZeroPad2D", "ZeroPad3D"},
    "functional": {
        "adaptive_avg_pool1d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
        "adaptive_max_pool2d", "adaptive_max_pool3d", "affine_grid",
        "avg_pool1d", "avg_pool3d", "channel_shuffle", "conv1d",
        "conv1d_transpose", "conv2d_transpose", "conv3d", "conv3d_transpose",
        "fold", "fractional_max_pool2d", "fractional_max_pool3d",
        "grid_sample", "group_norm", "instance_norm", "interpolate",
        "local_response_norm", "lp_pool1d", "lp_pool2d", "max_pool1d",
        "max_pool2d_with_index", "max_pool3d", "max_pool3d_with_index",
        "max_unpool1d", "max_unpool2d", "max_unpool3d", "pad",
        "pixel_shuffle", "pixel_unshuffle", "spectral_norm",
        "sync_batch_norm", "temporal_shift", "unfold", "upsample",
        "zeropad2d"},
    "utils": set(),
}
# helpers the reference's modules import for themselves, not API
NOT_API = {"Tensor", "apply_op"}


def _public(module, owner, keep=()):
    """Public callables of ``module`` defined in package ``owner``, and
    ``keep``."""
    return {k for k, v in vars(module).items()
            if not k.startswith("_") and callable(v) and
            ((getattr(v, "__module__", None) or "").startswith(owner + ".")
             or k in keep)}


def test_nn_surface_lacks_only_17_3b():
    """The port's ``nn``, ``nn.functional`` and ``nn.utils`` have every
    name of the reference's but item 17.3b's (43 classes, 40 functions):
    ``nn`` keeps its ``Tensor`` and ``Parameter`` re-exports."""
    import paddle_tpu.nn.functional as jF
    import paddle_tpu.nn.utils as jU
    import paddle_tpu_torch.nn.functional as tF
    import paddle_tpu_torch.nn.utils as tU
    assert len(MISSING_17_3B["nn"]) == 43
    assert len(MISSING_17_3B["functional"]) == 40
    for key, ref, port, drop in (("nn", jnn, tnn, set()),
                                 ("functional", jF, tF, NOT_API),
                                 ("utils", jU, tU, NOT_API)):
        want = _public(ref, "paddle_tpu") - drop
        have = _public(port, "paddle_tpu_torch", keep={"Tensor"}) - drop
        assert want - have == MISSING_17_3B[key], key
        assert not MISSING_17_3B[key] & have, key
