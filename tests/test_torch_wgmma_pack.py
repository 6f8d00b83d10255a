"""The weight packing of the bf16 forms of rows 3 and 5-8
(csrc/conv_bf16_wgmma.cu) on the CPU: ops/cuda/conv3d.py::pack_wgmma_weight,
the plain version the card test holds the packing kernel to byte for byte,
against a direct index of the weight. Exact: the packing only moves values and rounds each to
bf16 once."""
import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.ops.cuda import conv3d as tconv
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16


# The first six cases keep their ids: form False is the 2D conv's weight,
# True the transposed conv's.
@pytest.mark.parametrize("form,co,ci", [(False, 32, 32), (False, 64, 64), (False, 32, 13),
                                        (True, 64, 64), (True, 32, 64), (True, 32, 5),
                                        ("conv3d", 32, 32), ("conv3d", 64, 64),
                                        ("conv3d", 32, 13), ("conv3d", 64, 32),
                                        ("flip", 64, 64), ("flip", 32, 32), ("flip", 32, 13)])
def test_pack_wgmma_weight_is_a_direct_index(torch_one_thread, form, co, ci):
    """Element (cc, kd, tap, j, half, r, k) is the weight from input channel
    16 cc + 8 half + k to output channel 8 j + r at depth tap kd and tap
    (tap // 3, tap % 3), rounded to bf16, zero past Ci; the 2D weight has
    one depth tap, the transposed conv's (Ci, Co, 3, 3, 3) weight is read
    unflipped, the 3D conv's (Co, Ci, 3, 3, 3) as it is, and the flipped
    form (the input gradient's conv, Co and Ci of the packed conv) reads the
    forward weight (Ci, Co, 3, 3, 3) at (c, o, 2 - kd, 2 - kh, 2 - kw)."""
    form = {False: "conv2d", True: "deconv"}.get(form, form)
    gen = torch.Generator().manual_seed(co + ci + len(form))
    shape = {"conv2d": (co, ci, 3, 3), "deconv": (ci, co, 3, 3, 3),
             "conv3d": (co, ci, 3, 3, 3), "flip": (ci, co, 3, 3, 3)}[form]
    weight = torch.randn(shape, generator=gen)
    got = tconv.pack_wgmma_weight(weight, "conv" if form.startswith("conv") else form)
    wkd = 1 if form == "conv2d" else 3
    ci16 = -(-ci // 16)
    assert got.dtype == BF16 and tuple(got.shape) == (ci16, wkd, 9, co // 8, 2, 8, 8)
    w = weight.to(BF16).float().numpy()
    want = np.zeros(got.shape, np.float32)
    for cc, kd, tap, j, half, r, k in np.ndindex(*got.shape):
        c, o = 16 * cc + 8 * half + k, 8 * j + r
        if c < ci:
            kh, kw = divmod(tap, 3)
            want[cc, kd, tap, j, half, r, k] = {
                "conv2d": lambda: w[o, c, kh, kw], "deconv": lambda: w[c, o, kd, kh, kw],
                "conv3d": lambda: w[o, c, kd, kh, kw],
                "flip": lambda: w[c, o, 2 - kd, 2 - kh, 2 - kw]}[form]()
    assert np.array_equal(got.float().numpy(), want)
