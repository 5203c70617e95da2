"""The port's kernels.  Each module keeps its plain PyTorch version beside
the wrapper of its hand-written Hopper kernel (sources under ``csrc/``,
built by ``_build`` at first use)."""
