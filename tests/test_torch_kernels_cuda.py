"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch only (no jax), so it runs on a machine with an NVIDIA GPU and
nvcc: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q``.
Without a GPU every test skips. Tolerances: 3e-2 for bf16 (the kernel rounds
p to bf16 before p·v, the plain version sums in another order), 2e-5 for f32
with TF32 off.
"""

import numpy as np
import pytest
import torch

from pytorch_operator_tpu_torch.ops import _build
from pytorch_operator_tpu_torch.ops import flash_attention as fa

# (B, S, H, KH, D, causal, kv_len, dtype): the generate prefill shape first.
CASES = [
    (8, 512, 8, 4, 128, True, None, "bfloat16"),
    (2, 500, 8, 4, 128, True, None, "bfloat16"),
    (2, 256, 8, 4, 128, False, 200, "bfloat16"),
    (2, 192, 4, 4, 128, True, None, "bfloat16"),
    (2, 192, 8, 4, 64, True, None, "bfloat16"),
    (2, 130, 4, 2, 80, False, None, "bfloat16"),
    (2, 256, 8, 4, 128, True, None, "float32"),
    (1, 100, 4, 1, 64, False, 77, "float32"),
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


@pytest.mark.cuda
def test_build_reports_ptxas(cuda_device):
    """The build runs nvcc with ptxas's report on (registers, spills)."""
    fa.flash_attention(*(torch.zeros(1, 64, 2, 64, device=cuda_device) for _ in range(3)))
    path = _build.build(["flash_fwd"])["flash_fwd"]
    assert path.exists() and path.parent == _build.BUILD_DIR
    print(_build.build_logs.get("flash_fwd", "(library reused: no build this run)"))
