"""flash_roofline: the flash-attention kernel's share of its roofline over
the traced window, in %: the least time of the calls the window's prompts
need (one a layer a batch, causal, at the batch's shape) over the device
time of the kernels named flash_attention."""
from portbench.counts import kernels as K
from portbench.devicetrace import kernel_seconds


def read(ctx):
    cfg = ctx["config"]
    secs = kernel_seconds(ctx["trace"], "flash_attention")
    reqs = ctx["record"]["requests"]
    if secs <= 0 or not reqs:
        return None
    D = cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]
    dtype = ctx["traffic"]["run"]["compute_dtype"]
    bound = sum(cfg["n_layers"] * K.flash_attention(
        r["B"], r["S"], r["S"], cfg["n_heads"], cfg["n_kv_heads"], D, True,
        dtype) for r in reqs)
    return 100.0 * bound / secs
