"""Device reductions of the port: masked segment sums, the log-histogram
sketch, and the sketches' hashing, HyperLogLog, count-min and t-digest. Each
public function runs its hand CUDA kernel (``ops/kernels``) on a CUDA tensor
and its plain PyTorch version on a CPU tensor."""

from pixie_tpu_torch.ops import (  # noqa: F401
    countmin,
    hashing,
    histogram,
    hll,
    segment,
    tdigest,
)
