"""The whole bf16 spectrogram block's epilogue, on the CPU.

On the card a bf16 ``SpectrogramBlock`` in eval mode at Cout 8/16/32 runs
whole in one launch of ``specblock_bf16_tc_kernel<C, true>``
(``csrc/specblock.cu``): conv×3 + pool, then in the epilogue the block's
eval BatchNorm, its skip (bilinear resize by ½ and the 1×1 conv) and the
residual add, each rounded to bf16 where the module's stock ops round.
The kernel cannot run here, so these tests hold what it rests on:

* the bilinear resize by exactly ½ (``align_corners=False``) is the mean
  of each 2×2 window, 0.5·(0.5a + 0.5b) + 0.5·(0.5c + 0.5d) in float32 as
  the kernel's ``skip_means`` computes it, bit for bit, at the planes the
  fused blocks see;
* a float64 mirror of the epilogue's rounding points (BatchNorm → bf16,
  the means → bf16, the 1×1 conv over bf16 weights and bias → bf16, the
  add → bf16) equals the unfused bf16 eval block within one bf16 ulp;
* the engagement rule (``layers.block_path``) and the grad state the
  module hands it, and the counters a traced call ticks.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_brain_pattern_identification_xai_tpu_torch import (
    config as C, profiling)
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    layers)

BF16 = torch.bfloat16
#: (H, W) planes a fused block halves: block 1 and block 2 of the 400x300
#: program, and block 1 of the 200x150 preset (its block 2, 100x75, is odd)
PLANES = sorted({(400, 300), (200, 150), tuple(C.SPEC_RES_PRESET.image_size)})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_means(x: torch.Tensor) -> torch.Tensor:
    """``skip_means``'s arithmetic in float32 (numpy, one rounding an
    operation): a, b and c, d along W, rows combined last."""
    v = x.float().numpy()
    a, b = v[..., 0::2, 0::2], v[..., 0::2, 1::2]
    c, d = v[..., 1::2, 0::2], v[..., 1::2, 1::2]
    h = np.float32(0.5)
    m = h * (h * a + h * b) + h * (h * c + h * d)
    assert m.dtype == np.float32
    return torch.from_numpy(m).to(x.dtype)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("plane", PLANES)
def test_half_bilinear_is_2x2_mean(plane, dtype):
    """``bilinear_resize`` to (H/2, W/2) is the 2×2 mean, on the layouts
    the fused blocks see: block 1's min-max-scaled plane expanded to three
    channels (channel stride 0), a 16-channel map with signed values in
    NCHW and channels-last (block 2's).  bf16: bit for bit the kernel's
    float32 mean rounded to bf16, and ``avg_pool2d`` in float32 rounded to
    bf16.  float32: bit for bit the kernel's order on the contiguous map;
    torch's CPU takes another order on the other two (each tap weighted ¼,
    summed in sequence), so there within float32 rounding of the exact
    mean."""
    h, w = plane
    g = torch.Generator().manual_seed(h + w)
    plane1 = torch.rand((2, 1, h, w), generator=g).to(dtype)
    block2 = torch.randn((1, 16, h, w), generator=g).to(dtype)
    layouts = {"expanded": plane1.expand(2, 3, h, w), "nchw": block2,
               "channels_last": block2.contiguous(
                   memory_format=torch.channels_last)}
    for name, x in layouts.items():
        got = layers.bilinear_resize(x, (h // 2, w // 2))
        assert got.dtype == dtype and got.shape[-2:] == (h // 2, w // 2)
        if dtype == BF16 or name == "nchw":
            assert torch.equal(got, _kernel_means(x)), name
        if dtype == BF16:
            assert torch.equal(got, F.avg_pool2d(x.float(), 2).to(BF16))
        else:
            exact = F.avg_pool2d(x.double(), 2)
            size = F.avg_pool2d(x.double().abs(), 2)
            assert bool(((got.double() - exact).abs()
                         <= 2.0 ** -21 * size).all()), name


def _block(cin, cout, pool, seed):
    """A bf16 eval block with the benchmark's weight scales: convs N(0,
    1.4/fan_in), biases and running means sd 0.1, BatchNorm scales 1 +
    N(0, 0.1), running variances U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    blk = layers.SpectrogramBlock(cin, cout, pool_type=pool, dtype=BF16)
    with torch.no_grad():
        for m in (blk.conv1, blk.conv2, blk.conv3, blk.conv1x1):
            fan = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (1.4 / fan) ** 0.5)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
        bn = blk.bn
        bn.weight.copy_(1 + 0.1 * torch.randn(cout, generator=g))
        bn.bias.copy_(0.1 * torch.randn(cout, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(cout, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(cout, generator=g))
    return blk.eval()


def _r(t: torch.Tensor) -> torch.Tensor:
    """float64 → bf16 (round to nearest even) → float64."""
    return t.float().to(BF16).double()


def _mirror(blk, x):
    """The whole block's epilogue in float64 with bf16 rounding at the
    kernel's points, on the pooled conv chain ``p`` of the block's own
    stock convs."""
    h = x
    for conv in (blk.conv1, blk.conv2, blk.conv3):
        h = F.relu(layers._conv(conv, h))
    pool = F.max_pool2d if blk.pool_type == "max" else F.avg_pool2d
    p = pool(h, 2).double()
    bn = blk.bn
    shape = (1, -1, 1, 1)
    y = _r((p - bn.running_mean.double().view(shape))
           / torch.sqrt(bn.running_var.double().view(shape) + 1e-5)
           * bn.weight.double().view(shape) + bn.bias.double().view(shape))
    xd = x.double()
    means = _r(0.25 * ((xd[..., 0::2, 0::2] + xd[..., 0::2, 1::2])
                       + (xd[..., 1::2, 0::2] + xd[..., 1::2, 1::2])))
    w1 = _r(blk.conv1x1.weight.double()[:, :, 0, 0])
    skip = _r(torch.einsum("oc,bchw->bohw", w1, means)
              + _r(blk.conv1x1.bias.double()).view(shape))
    return _r(y + skip)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits; 2^-133 at zero)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("cout", [8, 16, 32])
@pytest.mark.parametrize("cin", [3, 16])
def test_epilogue_mirror_matches_unfused_block(cin, cout, pool):
    """The float64 mirror of the epilogue's rounding points against the
    unfused bf16 eval block (stock ops: float32 BatchNorm, torch's
    bilinear, the bf16 1×1 conv, the bf16 add): every element within one
    bf16 ulp, at least 99 % equal (all were at these seeds).  Cin 3
    is block 1's expanded plane (channel stride 0), on a ragged 36×22
    plane; Cin 16 a block-2-like input of ReLU outputs."""
    blk = _block(cin, cout, pool, seed=cin * 100 + cout)
    g = torch.Generator().manual_seed(cout)
    if cin == 3:
        x = torch.rand((2, 1, 36, 22), generator=g).to(BF16).expand(
            2, 3, 36, 22)
        assert x.stride(1) == 0
    else:
        x = torch.randn((2, cin, 20, 14), generator=g).relu().to(BF16)
    with torch.no_grad():
        got = blk(x).double()
        want = _mirror(blk, x)
    assert got.shape == want.shape == (2, cout, x.shape[2] // 2,
                                       x.shape[3] // 2)
    err = (got - want).abs()
    assert bool((err <= _ulp(want)).all()), float((err / _ulp(want)).max())
    assert float((err == 0).double().mean()) >= 0.99


def test_block_path_rule():
    """``block_path``: whole only for a fused eval call with a 2×2 pool on
    an even plane, on the card, in bf16, at Cout 8/16/32, with autograd
    not recording; each exclusion alone sends the call to the fused block
    (dtype, width, recording, the CPU) or to stock ops (not fused,
    training, another pool, an odd side)."""
    base = dict(fused=True, training=False, pool_size=(2, 2),
                plane=(400, 300), dtype=BF16, cout=16, recording=False,
                cuda=True)
    assert layers.block_path(**base) == "whole"
    for cout in (8, 16, 32):
        assert layers.block_path(**{**base, "cout": cout}) == "whole"
    for change, path in (
            ({"dtype": torch.float32}, "fused"),
            ({"dtype": torch.float16}, "fused"),
            ({"cout": 64}, "fused"), ({"cout": 256}, "fused"),
            ({"recording": True}, "fused"), ({"cuda": False}, "fused"),
            ({"fused": False}, "stock"), ({"training": True}, "stock"),
            ({"pool_size": (3, 3)}, "stock"), ({"plane": (100, 75)}, "stock"),
            ({"plane": (75, 100)}, "stock"), ({"plane": (1, 2)}, "stock")):
        assert layers.block_path(**{**base, **change}) == path, change


def test_block_hands_grad_state_to_rule(monkeypatch):
    """The module's ``recording``: false under ``no_grad`` and
    ``inference_mode`` and where nothing requires grad; true where grad
    mode is on and x or a parameter requires grad."""
    seen = []
    rule = layers.block_path

    def spy(*args):
        seen.append(args[6])
        return rule(*args)

    monkeypatch.setattr(layers, "block_path", spy)
    blk = _block(3, 16, "max", seed=0)
    blk.fused = True
    x = torch.rand((1, 1, 8, 6)).expand(1, 3, 8, 6).to(BF16)
    with torch.no_grad():
        blk(x)
    with torch.inference_mode():
        blk(x)
    blk(x)                                        # parameters require grad
    blk.requires_grad_(False)
    blk(x)                                        # nothing requires grad
    blk(x.clone().requires_grad_())
    with torch.no_grad():
        blk(x.clone().requires_grad_())
    assert seen == [False, False, True, False, True, False]


def test_traced_calls_count_fused_and_whole():
    """A traced fused call counts ``models.spec_block.fused``; on the CPU
    none is whole.  Untraced calls and stock calls count nothing."""
    blk = _block(3, 8, "avg", seed=1)
    x = torch.rand((1, 1, 8, 6)).expand(1, 3, 8, 6).to(BF16)
    before = dict(profiling.collect().counters)

    def delta(name):
        return (profiling.collect().counters.get(name, 0)
                - before.get(name, 0))

    with torch.no_grad():
        blk(x)                                    # stock, untraced
        with profiling.traced():
            blk(x)                                # stock, traced
        blk.fused = True
        blk(x)                                    # fused, untraced
        with profiling.traced():
            blk(x)
            blk(x)
    assert delta("models.spec_block.fused") == 2
    assert delta("models.spec_block.whole") == 0
