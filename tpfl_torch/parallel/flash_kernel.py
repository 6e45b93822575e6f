"""Flash attention with hand-written CUDA kernels — counterpart of
:mod:`tpfl.parallel.flash_kernel`.

:func:`flash_attention` is differentiable: q/k/v ``[B, S, H, D]`` ->
``[B, S, H, D]``. Its forward and its recompute-based backward (Dao et
al.) run three kernels from ``csrc/flash_attn.cu`` over operands folded
to ``[B·H, S, D]``:

- :func:`flash_fwd` — online-softmax forward, ``(o, lse)`` with the
  per-row logsumexp ``lse [B·H, S]`` f32 (replaces ``_fwd_kernel``);
- :func:`flash_dq` — ``dQ = scale·dS·K`` sweeping key tiles (replaces
  ``_dq_kernel``);
- :func:`flash_dkv` — ``dV = Pᵀ·dO``, ``dK = scale·dSᵀ·Q`` sweeping
  query tiles (replaces ``_dkv_kernel``).

Each wrapper runs its kernel's plain version (:func:`flash_fwd_plain`,
:func:`flash_dq_plain`, :func:`flash_dkv_plain`) when the tensors lie on
the CPU, and only then: on a CUDA tensor it launches the kernel or
raises. :func:`flash_block_fwd` / :func:`flash_block_bwd` are the ring's
step (``flash_kernel.py:334-420``): the same kernels on ``[B, S, H, D]``
blocks with f32 outputs and, backward, the caller's global ``lse`` /
``delta``. ``flash_fwd.launches`` etc. count kernel launches;
``flash_fwd.wgmma_launches`` etc. count those of them that took the
Hopper (wgmma + TMA) kernel, which the launcher picks by dtype and shape
and reports after the launch; the counts are exact under launches from
several threads at once (``_build.count_launch``). The plain versions loop over tiles of
keys (forward) or blocks of rows (backward), so no ``S × S`` tensor is
formed.

The numbers follow the reference (``flash_kernel.py:38-191``): operands
in their dtype with f32 accumulation, the scale ``1/sqrt(D)`` on the f32
scores, P and dS rounded to bf16 before their products when the
operands are bf16, causal mask ``q_pos >= k_pos`` with -1e30, and
``lse = m + log(max(l, 1e-30))``. Any S, any D and any B·H are taken
as they are: keys past S are masked in the kernels, so a non-causal
unaligned S needs no fallback; D past 128 runs in 128-column chunks of
the output; and the 8-lane ``lse`` rows and the D→128 padding of the
TPU layout are not reproduced.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tpfl_torch.parallel._build import count_launch

NEG_INF = -1e30  # flash_kernel.py:35
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Key rows per tile of the forward kernels (``kFwdKeys`` of the wgmma
#: kernel and ``kTile`` of the WMMA one in ``csrc/flash_attn.cu``): the
#: plain forward walks the same tiles, so it rounds P at the same running
#: max.
KEY_TILE = 64
#: Elements of a plain version's score block (f32 temporaries of this
#: size, a few at once): bounds its memory at long sequences.
_PLAIN_BLOCK_ELEMS = 1 << 26


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation (f64 stays f64, for gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _lowp(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_lowp`` of the reference: an f32 intermediate rounded to the
    operand dtype before the next product when that dtype is bf16."""
    return p.to(dtype).to(p.dtype) if dtype == torch.bfloat16 else p


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _rows_per_block(bh: int, s: int) -> int:
    return max(1, min(s, _PLAIN_BLOCK_ELEMS // max(1, bh * s)))


def _scores(qb: torch.Tensor, kb: torch.Tensor, q0: int, k0: int, causal: bool,
            scale: float) -> torch.Tensor:
    """Masked scores of query rows q0.. against key rows k0.. (both
    already in the accumulation dtype): [BH, |qb|, |kb|]."""
    s = torch.matmul(qb, kb.transpose(1, 2)) * scale
    if causal:
        qpos = torch.arange(q0, q0 + qb.shape[1], device=qb.device)
        kpos = torch.arange(k0, k0 + kb.shape[1], device=qb.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    out_dtype: Optional[torch.dtype] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd`: q/k/v ``[BH, S, D]`` ->
    ``(o [BH, S, D] in out_dtype, lse [BH, S] f32)`` (f64 for f64
    inputs). The kernel's online softmax over the same KEY_TILE-key
    tiles, for all query rows at once: P is rounded at the same running
    max, so the two differ by f32 summation order only."""
    bh, s, d = q.shape
    acc = _acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    m = torch.full((bh, s, 1), NEG_INF, dtype=acc, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=acc, device=q.device)
    o = torch.zeros((bh, s, d), dtype=acc, device=q.device)
    for k0 in range(0, s, KEY_TILE):
        q0 = k0 if causal else 0  # rows above the tile see none of it
        kt = slice(k0, k0 + KEY_TILE)
        sc = _scores(qf[:, q0:], kf[:, kt], q0, k0, causal, _scale(d))
        m_new = torch.maximum(m[:, q0:], sc.amax(-1, keepdim=True))
        corr = torch.exp(m[:, q0:] - m_new)
        p = torch.exp(sc - m_new)
        l[:, q0:] = l[:, q0:] * corr + p.sum(-1, keepdim=True)
        o[:, q0:] = o[:, q0:] * corr + torch.matmul(_lowp(p, v.dtype), vf[:, kt])
        m[:, q0:] = m_new
    l = torch.clamp(l, min=1e-30)
    return (o / l).to(out_dtype or q.dtype), (m + torch.log(l))[..., 0]


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of :func:`flash_dq`: ``dQ [BH, S, D]``."""
    bh, s, d = q.shape
    acc = _acc_dtype(q.dtype)
    dq = torch.empty((bh, s, d), dtype=out_dtype or q.dtype, device=q.device)
    qf, kf, vf, dof = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    blk = _rows_per_block(bh, s)
    for q0 in range(0, s, blk):
        sl = slice(q0, q0 + blk)
        p = torch.exp(_scores(qf[:, sl], kf, q0, 0, causal, _scale(d)) - lse[:, sl, None])
        dp = torch.matmul(dof[:, sl], vf.transpose(1, 2))
        ds = p * (dp - delta[:, sl, None])
        dq[:, sl] = (torch.matmul(_lowp(ds, k.dtype), kf) * _scale(d)).to(dq.dtype)
    return dq


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                    out_dtype: Optional[torch.dtype] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_dkv`: ``(dK, dV) [BH, S, D]``, one
    block of key rows against all queries at a time."""
    bh, s, d = q.shape
    acc = _acc_dtype(q.dtype)
    out_dtype = out_dtype or q.dtype
    dk = torch.empty((bh, s, d), dtype=out_dtype, device=q.device)
    dv = torch.empty((bh, s, d), dtype=out_dtype, device=q.device)
    qf, kf, vf, dof = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    blk = _rows_per_block(bh, s)
    for k0 in range(0, s, blk):
        sl = slice(k0, k0 + blk)
        p = torch.exp(_scores(qf, kf[:, sl], 0, k0, causal, _scale(d)) - lse[..., None])
        dv[:, sl] = torch.matmul(_lowp(p, do.dtype).transpose(1, 2), dof).to(out_dtype)
        dp = torch.matmul(dof, vf[:, sl].transpose(1, 2))
        ds = p * (dp - delta[..., None])
        dk[:, sl] = (torch.matmul(_lowp(ds, q.dtype).transpose(1, 2), qf)
                     * _scale(d)).to(out_dtype)
    return dk, dv


# ---- the kernels ---------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from tpfl_torch.parallel import _build

    lib = _build.load("flash_attn")
    if not getattr(lib, "_tpfl_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [f, i, i, vp, ctypes.POINTER(i)]
        lib.tpfl_flash_fwd.argtypes = [vp] * 5 + [i] * 4 + tail
        lib.tpfl_flash_fwd.restype = i
        lib.tpfl_flash_dq.argtypes = [vp] * 7 + [i] * 4 + tail
        lib.tpfl_flash_dq.restype = i
        lib.tpfl_flash_dkv.argtypes = [vp] * 8 + [i] * 4 + tail
        lib.tpfl_flash_dkv.restype = i
        lib._tpfl_typed = True
    return lib


def _check_cuda(out_dtype: Optional[torch.dtype], *operands: torch.Tensor,
                rows: tuple[torch.Tensor, ...] = ()) -> tuple[int, int, torch.dtype]:
    """(dtype code, output dtype code, output dtype) for operands
    ``[BH, S, D]`` of one dtype and f32 row vectors ``[BH, S]``."""
    q = operands[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels: tensors on {q.device}, not on the CPU or a card")
    if q.dim() != 3:
        raise ValueError(f"flash kernels: operands are [BH, S, D], got {tuple(q.shape)}")
    for t in operands + rows:
        if t.device != q.device:
            raise ValueError("flash kernels: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("flash kernels: operands must be contiguous")
    for t in operands:
        if t.dtype != q.dtype:
            raise TypeError(f"flash kernels: operand dtypes differ ({t.dtype} vs {q.dtype})")
        if t.shape != q.shape:
            raise ValueError(f"flash kernels: shapes differ ({tuple(t.shape)} vs {tuple(q.shape)})")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != q.shape[:2]:
            raise TypeError("flash kernels: lse / delta must be f32 [BH, S]")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels: unsupported dtype {q.dtype}")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in _DTYPE_CODES or (q.dtype == torch.float32 and out_dtype != q.dtype):
        raise TypeError(f"flash kernels: unsupported output dtype {out_dtype} for {q.dtype}")
    if min(q.shape) < 1:
        raise ValueError(f"flash kernels: empty operands {tuple(q.shape)}")
    return _DTYPE_CODES[q.dtype], _DTYPE_CODES[out_dtype], out_dtype


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              out_dtype: Optional[torch.dtype] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of q/k/v ``[BH, S, D]``: o in ``out_dtype`` (q's by
    default), lse ``[BH, S]`` f32. CPU tensors take
    :func:`flash_fwd_plain`; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, out_dtype)
    code, out_code, out_dtype = _check_cuda(out_dtype, q, k, v)
    bh, s, d = q.shape
    o = torch.empty((bh, s, d), device=q.device, dtype=out_dtype)
    lse = torch.empty((bh, s), device=q.device, dtype=torch.float32)
    took_wgmma = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = _lib().tpfl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    lse.data_ptr(), bh, s, d, int(causal), _scale(d), code,
                                    out_code, _stream(q), ctypes.byref(took_wgmma))
    _raise_on(err, "flash_fwd")
    count_launch(flash_fwd, took_wgmma.value)
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dQ ``[BH, S, D]`` from the operands, dO, and the f32 row
    residuals ``lse`` and ``delta = rowsum(dO·O)`` ``[BH, S]``. CPU
    tensors take :func:`flash_dq_plain`; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, out_dtype)
    code, out_code, out_dtype = _check_cuda(out_dtype, q, k, v, do, rows=(lse, delta))
    bh, s, d = q.shape
    dq = torch.empty((bh, s, d), device=q.device, dtype=out_dtype)
    took_wgmma = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = _lib().tpfl_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
                                   int(causal), _scale(d), code, out_code, _stream(q),
                                   ctypes.byref(took_wgmma))
    _raise_on(err, "flash_dq")
    count_launch(flash_dq, took_wgmma.value)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool,
              out_dtype: Optional[torch.dtype] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) ``[BH, S, D]``, arguments as :func:`flash_dq`. CPU
    tensors take :func:`flash_dkv_plain`; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, out_dtype)
    code, out_code, out_dtype = _check_cuda(out_dtype, q, k, v, do, rows=(lse, delta))
    bh, s, d = q.shape
    dk = torch.empty((bh, s, d), device=q.device, dtype=out_dtype)
    dv = torch.empty((bh, s, d), device=q.device, dtype=out_dtype)
    took_wgmma = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = _lib().tpfl_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), bh, s, d, int(causal), _scale(d), code,
                                    out_code, _stream(q), ctypes.byref(took_wgmma))
    _raise_on(err, "flash_dkv")
    count_launch(flash_dkv, took_wgmma.value)
    return dk, dv


flash_fwd.launches = 0
flash_fwd.wgmma_launches = 0
flash_dq.launches = 0
flash_dq.wgmma_launches = 0
flash_dkv.launches = 0
flash_dkv.wgmma_launches = 0


# ---- differentiable attention ------------------------------------------------------


def _fold_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> contiguous [B·H, S, D] (``_prep`` without the
    TPU padding)."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _unfold_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_fwd` forward; :func:`flash_dq` / :func:`flash_dkv`
    backward with ``delta = rowsum(dO·O)`` in f32 (plain torch, as the
    reference computes it outside Pallas, ``flash_kernel.py:313-316``)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
        b, _, h, _ = q.shape
        qp, kp, vp = _fold_heads(q), _fold_heads(k), _fold_heads(v)
        o, lse = flash_fwd(qp, kp, vp, causal)
        ctx.save_for_backward(qp, kp, vp, o, lse)
        ctx.causal, ctx.bh = causal, (b, h)
        return _unfold_heads(o, b, h)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qp, kp, vp, o, lse = ctx.saved_tensors
        b, h = ctx.bh
        do = _fold_heads(dout.to(qp.dtype))
        acc = _acc_dtype(qp.dtype)
        delta = (do.to(acc) * o.to(acc)).sum(-1)
        dq = flash_dq(qp, kp, vp, do, lse, delta, ctx.causal)
        dk, dv = flash_dkv(qp, kp, vp, do, lse, delta, ctx.causal)
        return (_unfold_heads(dq, b, h), _unfold_heads(dk, b, h),
                _unfold_heads(dv, b, h), None)


def ring_block_size(s: int, block: int) -> int:
    """Largest block ≤ ``block`` that tiles ``s`` exactly
    (``flash_kernel.py:334-345``): a multiple of 8 that divides ``s``, or
    ``s`` itself. The reference's kernels tile by it; the port's choose
    their own tiles and mask keys past S, so the ring never needs it. Kept
    for parity of the reference's API."""
    if s <= block:
        return s
    blk = (min(block, s) // 8) * 8
    while blk >= 8 and s % blk:
        blk -= 8
    return blk if blk >= 8 and s % blk == 0 else s


def flash_block_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """One flash forward over a (q block, kv block) pair, the ring's step
    (``flash_kernel.py:356-379``): q/k/v ``[B, S, H, D]`` ->
    ``(out [B, S, H, D] f32, lse [B, H, S] f32)``. f32 out, as the
    reference's: the ring merges its steps at f32, and rounding each step
    to q's dtype first would round every block before the logsumexp
    rescale. Not differentiable on its own: the ring defines its own
    backward. ``block`` is kept for parity; the kernels choose their
    tiles."""
    del block
    b, s, h, _ = q.shape
    o, lse = flash_fwd(_fold_heads(q), _fold_heads(k), _fold_heads(v), causal,
                       out_dtype=torch.float32)
    return _unfold_heads(o, b, h), lse.reshape(b, h, s)


def flash_block_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor, causal: bool,
                    block: int = 1024) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward for one (q block, kv block) pair with caller-supplied
    softmax residuals (``flash_kernel.py:382-420``): ``lse`` / ``delta``
    ``[B, H, S]`` f32 of the WHOLE attention row (every ring step), so the
    steps' contributions sum to the global gradient. Returns
    ``(dq, dk, dv) [B, S, H, D]`` in f32: they sum in the ring's f32
    accumulators. ``do`` takes q's dtype (the kernels read one dtype)."""
    del block
    b, s, h, _ = q.shape
    args = (_fold_heads(q), _fold_heads(k), _fold_heads(v), _fold_heads(do.to(q.dtype)),
            lse.reshape(b * h, s).to(torch.float32).contiguous(),
            delta.reshape(b * h, s).to(torch.float32).contiguous(), causal)
    dq = flash_dq(*args, out_dtype=torch.float32)
    dk, dv = flash_dkv(*args, out_dtype=torch.float32)
    return _unfold_heads(dq, b, h), _unfold_heads(dk, b, h), _unfold_heads(dv, b, h)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block: int = 1024) -> torch.Tensor:
    """Flash attention, differentiable: q/k/v ``[B, S, H, D]`` ->
    ``[B, S, H, D]`` in q's dtype.

    ``block`` is kept for parity with the reference's signature; the
    CUDA kernels choose their own tiles whatever it is, and no S
    (aligned or not, causal or not) needs a fallback."""
    del block
    return FlashAttention.apply(q, k, v, causal)


__all__ = [
    "FlashAttention", "flash_attention", "flash_block_bwd", "flash_block_fwd", "flash_dkv",
    "flash_dkv_plain", "flash_dq", "flash_dq_plain", "flash_fwd", "flash_fwd_plain",
    "ring_block_size",
]
