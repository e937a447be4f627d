"""The port's flash attention against the JAX package's Pallas kernel.

The same inputs, made with numpy from a seed, go through
``tpusim.models.pallas_attention.flash_attention`` in interpret mode and
through ``tpusim_torch``'s ``flash_attention`` on the CPU (where the
wrapper takes the plain PyTorch version).  Tolerance: atol 2e-5 in f32,
the JAX package's own for this kernel (tests/test_pallas.py); the two
differ by ~1e-7 here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpusim.models.pallas_attention import flash_attention as jax_flash  # noqa: E402
from tpusim_torch.kernels import build  # noqa: E402
from tpusim_torch.kernels import flash_attention as fa  # noqa: E402
from tpusim_torch.models.flash_attention import (  # noqa: E402
    flash_attention,
    from_numpy,
    resolve_device,
)

ATOL = 2e-5


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(3))


@functools.lru_cache(maxsize=None)
def _pallas(shape, block_q, seed=0):
    q, k, v = _inputs(shape, seed)
    return np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=block_q, interpret=True,
    ))


def _tf32_round(x):
    """x rounded to TF32 as the kernel rounds the high part of its split:
    the low 13 mantissa bits rounded off, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x):
    """What the tensor core reads of a float32 register: the top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, split):
    """a @ b as the tensor cores compute it from float32 operands: one TF32
    product, or the split hi*hi + hi*lo + lo*hi; exact products, float32
    result."""
    a_hi, b_hi = _tf32_round(a), _tf32_round(b)
    if not split:
        return (a_hi.double() @ b_hi.double()).float()
    a_lo, b_lo = _tf32_read(a - a_hi), _tf32_read(b - b_hi)
    return (a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
            + a_hi.double() @ b_hi.double()).float()


def _attention_tf32(q, k, v, split):
    """The kernel's f32 arithmetic, emulated: both products on the tensor
    cores, the softmax in float32."""
    s = _mm_tf32(q, k.transpose(-1, -2), split) / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _mm_tf32(p, v, split) / p.sum(dim=-1, keepdim=True)


def attention_f64(q, k, v) -> np.ndarray:
    """softmax(q kᵀ/√D) v in float64, the yardstick both sides are read
    against when they miss each other."""
    q, k, v = (np.asarray(a, dtype=np.float64) for a in (q, k, v))
    s = q @ np.swapaxes(k, -1, -2) / math.sqrt(q.shape[-1])
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return (p @ v) / p.sum(axis=-1, keepdims=True)


def miss_report(port: np.ndarray, pallas: np.ndarray,
                exact: np.ndarray) -> str:
    """Which side moved: each side's worst distance from the float64
    evaluation, and the element, beside the worst gap between them."""
    parts = []
    for label, x in (("port", port), ("pallas", pallas)):
        d = np.abs(x.astype(np.float64) - exact)
        i = tuple(int(j) for j in np.unravel_index(int(d.argmax()), d.shape))
        parts.append(f"{label} worst |x - f64| {d[i]:.4g} at {i} "
                     f"(x {float(x[i])!r}, f64 {float(exact[i])!r})")
    gap = np.abs(port.astype(np.float64) - pallas)
    i = tuple(int(j) for j in np.unravel_index(int(gap.argmax()), gap.shape))
    parts.append(f"worst port-pallas gap {gap[i]:.4g} at {i}")
    return "; ".join(parts)


@pytest.mark.parametrize("shape,block_q", [
    ((2, 256, 64), 128),
    ((2, 192, 32), 64),
    ((4, 128, 64), 128),
])
def test_matches_pallas_interpret(shape, block_q):
    q, k, v = _inputs(shape)
    want = _pallas(shape, block_q)
    got = flash_attention(*from_numpy(q, k, v, device="cpu"), block_q=block_q)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=ATOL,
        err_msg=miss_report(got.numpy(), want, attention_f64(q, k, v)))


def test_bf16_computes_in_f32_and_casts_back():
    q, k, v = _inputs((2, 128, 64), seed=1)
    tq, tk, tv = (t.to(torch.bfloat16)
                  for t in from_numpy(q, k, v, device="cpu"))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = fa.flash_attention_reference(tq.float(), tk.float(), tv.float())
    # one bf16 rounding of the output: within one ulp (2^-7 relative)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("shape,block_q", [((2, 200, 64), 128),
                                           ((1, 96, 32), 64)])
def test_sequence_not_divisible_raises(shape, block_q):
    # the TPU grid floors S // block_q and leaves the tail rows unwritten;
    # the port refuses such shapes
    q, k, v = from_numpy(*_inputs(shape), device="cpu")
    with pytest.raises(ValueError, match="not a multiple of block_q"):
        flash_attention(q, k, v, block_q=block_q)


def test_rejects_bad_inputs():
    q, k, v = from_numpy(*_inputs((1, 64, 32)), device="cpu")
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :32], v)
    big = torch.zeros(1, 8, 256)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big)


def test_other_devices_raise_instead_of_falling_back():
    # neither kernel nor plain version takes a tensor that is on neither
    # the card nor the CPU: no quiet route
    q = torch.empty(1, 64, 32, device="meta")
    with pytest.raises(ValueError, match="no flash_attention for device"):
        fa.flash_attention_fwd(q, q, q)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy(*_inputs((1, 8, 8)), device="cuda")


def test_launch_counter_stays_zero_on_cpu():
    fa.reset_launch_count()
    q, k, v = from_numpy(*_inputs((1, 64, 32)), device="cpu")
    flash_attention(q, k, v)
    assert fa.launch_count() == 0


def test_kernel_source_and_build_command_are_present(tmp_path):
    src = build.CSRC_DIR / "flash_attention.cu"
    text = src.read_text()
    # the C interface the ctypes wrapper binds, and the note the source
    # owes its reader: which TPU kernel, what bounds it, what the design does
    assert 'extern "C"' in text
    assert "int tpusim_flash_attention_fwd(" in text
    assert "tpusim/models/pallas_attention.py" in text
    assert "bound" in text
    # both products on the tensor cores, f32 as split TF32, K/V tiles
    # through asynchronous copies (the PTX lives in the csrc headers)
    ptx = text + "".join(h.read_text() for h in build.CSRC_DIR.glob("*.cuh"))
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in ptx
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in ptx
    assert "split_tf32" in text and "mma_tf32x3" in text
    assert "cp.async" in ptx
    assert "fmaf" not in text
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    cmd = build.nvcc_command("flash_attention", tmp_path / "lib.so",
                             nvcc="nvcc")
    assert cmd[0] == "nvcc" and cmd[-1] == str(src)
    # the build lands in a git-ignored directory keyed on the source hash
    so = build.library_path("flash_attention")
    assert so.parent.parent == build.BUILD_DIR
    assert so.parent.name.startswith("flash_attention-")
    gitignore = (build.BUILD_DIR.parents[1] / ".gitignore").read_text()
    assert "build/" in gitignore.split()


@pytest.mark.parametrize("split", [True, False],
                         ids=["split_tf32", "one_tf32_product"])
def test_tf32_split_decides_the_f32_tolerance(split):
    # the kernel's f32 path runs on the tensor cores; split TF32 stays
    # within the JAX package's atol 2e-5 of the Pallas kernel, one TF32
    # product (10 mantissa bits) does not
    shape = (2, 256, 64)
    want = _pallas(shape, 128)
    q, k, v = from_numpy(*_inputs(shape), device="cpu")
    err = np.abs(_attention_tf32(q, k, v, split).numpy() - want).max()
    if split:
        assert err <= ATOL
    else:
        assert err > 5 * ATOL


def test_bf16_p_rounded_once_stays_within_bf16_tolerance():
    # bf16 inputs: exact bf16 products summed in f32 for Q K^T, then P is
    # rounded once to bf16 for P V (the row sum stays f32), as the kernel
    # does; held to the plain version with chip_smoke's bf16 tolerance
    q, k, v = (t.to(torch.bfloat16) for t in
               from_numpy(*_inputs((4, 256, 128), seed=2), device="cpu"))
    want = fa.flash_attention_reference(q, k, v).float()
    qf, kf, vf = q.double(), k.double(), v.double()
    s = (qf @ kf.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = (p.to(torch.bfloat16).double() @ vf).float()
    got = (pv / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    diff = (got - want).abs()
    assert bool((diff <= 1e-2 + 1e-2 * want.abs()).all())
    assert diff.max().item() > 0  # the rounding of P is seen


def test_build_key_covers_headers(tmp_path, monkeypatch):
    # an edited csrc/*.cuh must never load a library built before the edit
    (tmp_path / "kern.cu").write_text('#include "ptx.cuh"\n')
    header = tmp_path / "ptx.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("kern")
    assert build.library_path("kern") == first
    header.write_text("// v2\n")
    second = build.library_path("kern")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build.library_path("kern") not in (first, second)
