"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package compiles nothing: the library is built the
first time a wrapper is given a CUDA tensor."""
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward,
                                         rmsnorm_backward_plain, rmsnorm_plain)
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain

__all__ = ["flash_attention", "flash_attention_plain", "rmsnorm",
           "rmsnorm_backward", "rmsnorm_backward_plain", "rmsnorm_plain",
           "ssd", "ssd_plain", "wkv6", "wkv6_plain"]
