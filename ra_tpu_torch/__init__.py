"""ra_tpu_torch — the PyTorch/CUDA port of ra_tpu.

Same layout and names as ``ra_tpu``: the consensus decision hot path
runs as PyTorch tensor code over group-id-indexed device arrays, with the
quorum scan as a hand-written CUDA kernel (``csrc/quorum.cu``), while
log/WAL/snapshot I/O stays on the host. It imports neither JAX nor the
``ra_tpu`` package: the host modules it needs are its own copies.
"""

__version__ = "0.1.0"
