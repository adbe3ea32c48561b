"""The model under autograd outside the port's own kernels: device
milliseconds a step of every operation that is not one of the kernels of
``voicemap_tpu_torch/csrc/`` (cuDNN's convs, PyTorch's elementwise kernels,
reductions, copies and fills, Adam)."""

# Every __global__ function of voicemap_tpu_torch/csrc/.
OWN = (r"\b(gather_whiten_kernel|conv_block0_kernel|conv_block0_tc_kernel|block0_train_tc"
       r"|block0_train_tc32|conv_blockn_kernel|quant_block_kernel|pool_fwd_kernel"
       r"|route_bwd_kernel|log_mel_tc_kernel|log_mel_fft_kernel|tile_kernel|row_kernel"
       r"|fold_rows_kernel)\b")


def read(t):
    if not t.device or t.work["steps"] == 0:
        return None
    return 1e3 * t.seconds_of(OWN, exclude=True) / t.work["steps"]
