"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch only (no jax), so it runs on a machine with an NVIDIA GPU and
nvcc: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q``.
Without a GPU every test skips. Forward tolerances: 3e-2 for bf16 (the
kernel rounds p to bf16 before p·v, the plain version sums in another order),
2e-5 for f32 with TF32 off, on the largest absolute error of o and lse; and o
by ``flash_attention.forward_agreement``'s relative checks, since a late causal
row's o is far below the first rows'. Backward (dq, dk, dv against
``flash_attention_backward_reference`` on the same padded inputs, the
kernel's own o and lse, and through autograd against the plain forward and
backward): ``flash_attention.grad_agreement``, a relative L2 error over the
whole gradient and over its late half within ``GRAD_RTOL`` (bf16 5e-3, f32
1e-4) and in its worst row within ``ROW_RTOL`` (bf16 3e-2, f32 3e-4), so
that a fault in late tiles shows although causal gradients there are far
below the first keys'.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_operator_tpu_torch.ops import _build
from pytorch_operator_tpu_torch.ops import flash_attention as fa

# (B, S, H, KH, D, causal, kv_len, dtype): the generate prefill shape first.
# The bf16 kernels take 128 query rows (forward, dq) or 128 keys (dkv, two
# warpgroups of 64) a CTA, and 128 (forward) or 64 (dq) keys or 64 query rows
# (dkv) a tile, so the cases include S 192 (a last query tile, and a last dkv
# CTA's second warpgroup, past S), S 64 (one tile, smaller than the CTA's
# rows), a kv_len inside a tile, G 8 (dkv's longest walk over query heads),
# causal kv_len 100 (ending inside a dkv CTA's second warpgroup) and kv_len 40
# (that warpgroup wholly masked). The last is ViT-B/16's attention at 224 px
# (197 tokens padded to 256, the padded keys masked; 12 heads of 64;
# non-causal) at batch 4.
CASES = [
    (8, 512, 8, 4, 128, True, None, "bfloat16"),
    (2, 500, 8, 4, 128, True, None, "bfloat16"),
    (2, 256, 8, 4, 128, False, 200, "bfloat16"),
    (2, 192, 4, 4, 128, True, None, "bfloat16"),
    (2, 192, 8, 4, 64, True, None, "bfloat16"),
    (2, 130, 4, 2, 80, False, None, "bfloat16"),
    (2, 256, 8, 4, 128, True, None, "float32"),
    (1, 100, 4, 1, 64, False, 77, "float32"),
    (2, 192, 8, 4, 128, True, None, "bfloat16"),
    (2, 64, 8, 4, 128, True, None, "bfloat16"),
    (2, 256, 8, 4, 64, False, 77, "bfloat16"),
    (2, 256, 8, 1, 128, True, None, "bfloat16"),
    (2, 256, 8, 4, 128, True, 100, "bfloat16"),
    (2, 192, 8, 4, 64, False, 40, "bfloat16"),
    (4, 197, 12, 12, 64, False, None, "bfloat16"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case_id(c):
    B, S, H, KH, D, causal, kv_len, dtype = c
    return f"B{B}-S{S}-H{H}-KH{KH}-D{D}-{'causal' if causal else 'full'}-kv{kv_len}-{dtype}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flash_fwd_matches_plain(cuda_device, case):
    B, S, H, KH, D, causal, kv_len, dtype = case
    dt = getattr(torch, dtype)
    tol = 3e-2 if dt == torch.bfloat16 else 2e-5
    rng = np.random.default_rng(0)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((B, S, h, D), dtype=np.float32)).to(cuda_device, dt)
        for h in (H, KH, KH)
    )
    before = fa.launch_count
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    o_ref, lse_ref = fa.flash_attention_with_lse(
        q.cpu(), k.cpu(), v.cpu(), causal=causal, kv_len=kv_len
    )
    assert o.dtype == dt and o.shape == (B, S, H, D) and lse.shape == (B * H, S)
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float().cpu(), o_ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse.cpu(), lse_ref, atol=tol, rtol=0)
    agree = fa.forward_agreement(o.cpu(), lse.cpu(), o_ref, lse_ref, S)
    assert agree["ok"], agree


def _rand(shape, dt, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flash_bwd_matches_plain(cuda_device, case):
    """Both backward kernels against their plain version on the same padded
    inputs, the forward kernel's o and lse, on the card."""
    B, S, H, KH, D, causal, kv_len, dtype = case
    dt = getattr(torch, dtype)
    _, _, S_pad, D_pad = fa._plan_tiling(S, D, 1024, 1024, True)
    pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
    q, k, v, do = (
        F.pad(_rand((B, S, h, D), dt, cuda_device, seed), pad)
        for seed, h in enumerate((H, KH, KH, H))
    )
    kv = kv_len or S
    args = dict(causal=causal, kv_len=kv, scale=1.0 / math.sqrt(D))
    o, lse = fa._launch(q, k, v, **args)
    before = (fa.dq_launch_count, fa.dkv_launch_count)
    grads = fa._launch_bwd(q, k, v, o, lse, do, **args)
    torch.cuda.synchronize()
    assert (fa.dq_launch_count, fa.dkv_launch_count) == (before[0] + 1, before[1] + 1)
    refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dt and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        agree = fa.grad_agreement(g, r, S)
        assert agree["ok"], (name, agree)


@pytest.mark.cuda
def test_autograd_through_kernels(cuda_device):
    """Gradients through the public function launch each kernel once, flow
    through the padding (S 100, D 80), and agree with the CPU path (plain
    forward and backward) in f32."""
    B, S, H, KH, D = 2, 100, 4, 2, 80
    q, k, v, w = (_rand((B, S, h, D), torch.float32, "cpu", s) for s, h in enumerate((H, KH, KH, H)))
    grads = {}
    for dev in ("cpu", "cuda"):
        qkv = [x.to(dev).requires_grad_() for x in (q, k, v)]
        fa.reset_launch_count()
        o = fa.flash_attention(*qkv, causal=True)
        grads[dev] = torch.autograd.grad((o * w.to(dev)).sum(), qkv)
    assert (fa.launch_count, fa.dq_launch_count, fa.dkv_launch_count) == (1, 1, 1)
    for g_cpu, g_cuda in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(g_cuda.cpu(), g_cpu, atol=5e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,H,KH,D", [(2, 500, 8, 4, 80), (2, 1024, 8, 4, 128)], ids=["S500-D80", "S1024-D128"]
)
def test_autograd_through_kernels_bf16(cuda_device, B, S, H, KH, D):
    """bf16 gradients through the public function (both backward kernels,
    the wrapper's pad of do and slice of the gradients) against the plain
    forward and backward on the same, unpadded inputs."""
    q, k, v, do = (_rand((B, S, h, D), torch.bfloat16, cuda_device, s)
                   for s, h in enumerate((H, KH, KH, H)))
    qkv = [x.requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*qkv, causal=True), qkv, do)
    args = dict(causal=True, kv_len=S, scale=1.0 / math.sqrt(D))
    o, lse = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(), **args)
    refs = fa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), o, lse, do, **args
    )
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        agree = fa.grad_agreement(g, r, S)
        assert agree["ok"], (name, agree)


@pytest.mark.cuda
def test_build_reports_ptxas(cuda_device):
    """The build runs nvcc with ptxas's report on (registers, spills)."""
    fa.flash_attention(*(torch.zeros(1, 64, 2, 64, device=cuda_device) for _ in range(3)))
    paths = _build.build(["flash_fwd", "flash_bwd"])
    for name, path in paths.items():
        assert path.exists() and path.parent == _build.BUILD_DIR
        print(_build.build_logs.get(name, f"{name}: library reused, no build this run"))


@pytest.mark.cuda
def test_vit_flash_path_launches_each_kernel_once_a_layer(cuda_device):
    """ViT-B/16 width at depth 2, 224 px, batch 2, bf16: one training step
    with ``attn_impl="flash"`` launches each kernel once a layer, and its
    logits and loss agree with the dense model's on the same weights (both
    round p to bf16 before p·v, at different points)."""
    from pytorch_operator_tpu_torch.models import vit

    x = _rand((2, 224, 224, 3), torch.float32, cuda_device, 0)
    y = torch.tensor([3, 7], device=cuda_device)
    out = {}
    for impl in ("dense", "flash"):
        model = vit.ViT(vit.vit_b16(depth=2, attn_impl=impl), device=cuda_device)
        with torch.no_grad():  # a zero head reads nothing: the same random head for both
            model.head.weight.normal_(0.0, 0.02, generator=torch.Generator(cuda_device).manual_seed(1))
        fa.reset_launch_count()
        logits = model(x)
        F.cross_entropy(logits, y).backward()
        torch.cuda.synchronize()
        out[impl] = (logits.detach().float().cpu(), fa.launch_counts())
    assert out["flash"][1] == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert out["dense"][1] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    torch.testing.assert_close(out["flash"][0], out["dense"][0], atol=5e-2, rtol=0)
