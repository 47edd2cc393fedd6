"""QK RMSNorm + RoPE + the joint [text | image] layout of a FLUX block's
attention input: the CUDA kernels' wrappers, their plain PyTorch version, and
the autograd function that joins them.

Replaces no Pallas kernel: in the JAX package XLA fused the QK-norm, the
rotation and the concatenation into the attention's input, so
``mixgrpo_tpu/`` has no ``pallas_call`` for them.  The port ran them as
eager ops, and the kernels (``csrc/qk_rope.cu``, CUDA C++ loaded with ctypes;
its source note gives the design and the bounds) do the same arithmetic in
one pass over the projection outputs.  Each wrapper counts its launches in
``.launches``: one ``qk_rope_fwd`` per FLUX block a DiT call, one
``qk_rope_bwd`` per block a backward.

``qk_rope(sources, qscales, kscales, cos, sin, eps, num_heads, layout)``:
  - ``sources``: one or two (B, L_i, 3*H*D) projection outputs, [q | k | v]
    by columns, read through their row strides (a single block's ``linear1``
    view of width 3h needs no copy); the joint sequence is their tokens in
    order (the double block passes [text, image]);
  - ``qscales``, ``kscales``: each source's (D,) QK-norm scales;
  - ``cos``, ``sin``: f32 RoPE tables over the joint sequence, (S, D), or
    (S, 1, D) under bshd;
  - returns q, k and v in the attention layout (``"bhsd"`` (B, H, S, D) or
    ``"bshd"`` (B, S, H, D)), q and k normalised in f32, rounded, scaled in
    the sources' dtype and rotated in f32, as ``layers.rms_norm`` and
    ``rope.apply_rope`` round.

Dispatch is by the device the tensors lie on: CPU tensors run the plain
version (``qk_rope_reference``, the eager composition the blocks ran before
the kernel), and autograd differentiates it; CUDA tensors launch the kernels
(bf16 or f32, D in 32/64/128) or raise.  There is no fallback from a kernel to
its plain version.  The forward stores each row's f32 rsqrt of q and of k only
when a gradient will be taken, and the backward writes d(source) as one
contiguous tensor a source, and d(scale) only for a scale that requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from mixgrpo_tpu_torch.models.flux.layers import rms_norm
from mixgrpo_tpu_torch.models.flux.rope import apply_rope
from mixgrpo_tpu_torch.ops import build

KERNEL = "qk_rope"  # the library of both kernels
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_THREADS, _BLOCKS_PER_SM = 256, 8  # csrc/qk_rope.cu's block and the grid's cap


def split_heads(x, num_heads, layout):
    """(B, S, H*D) -> (B, H, S, D), or (B, S, H, D) under bshd (a view)."""
    b, s, _ = x.shape
    x = x.reshape(b, s, num_heads, -1)
    return x if layout == "bshd" else x.transpose(1, 2)


def _tables(cos, sin, S):
    """The (S, D) views of the RoPE tables, given as (S, D) or (S, 1, D)."""
    if cos.shape[0] != S or cos.shape != sin.shape or cos.ndim not in (2, 3):
        raise ValueError(f"RoPE tables {tuple(cos.shape)}, {tuple(sin.shape)} do not "
                         f"cover the joint sequence of {S} tokens")
    D = cos.shape[-1]
    return cos.reshape(S, D), sin.reshape(S, D)


# ----------------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------------


def qk_rope_reference(sources, qscales, kscales, cos, sin, eps, num_heads, layout):
    """Plain PyTorch version, the eager ops the FLUX blocks ran before the
    kernel: each source split into heads, q and k RMS-normalised with their
    scales, the sources joined along the sequence, q and k rotated."""
    S = sum(x.shape[1] for x in sources)
    cos, sin = _tables(cos, sin, S)
    if layout == "bshd":  # (S, 1, D): S lines up with the token axis
        cos, sin = cos[:, None, :], sin[:, None, :]
    qs, ks, vs = [], [], []
    for x, qscale, kscale in zip(sources, qscales, kscales):
        q, k, v = (split_heads(t, num_heads, layout) for t in x.chunk(3, dim=-1))
        qs.append(rms_norm(q, qscale, eps))
        ks.append(rms_norm(k, kscale, eps))
        vs.append(v)
    seq = 1 if layout == "bshd" else 2
    join = lambda ts: ts[0] if len(ts) == 1 else torch.cat(ts, dim=seq)
    return apply_rope(join(qs), cos, sin), apply_rope(join(ks), cos, sin), join(vs)


# ----------------------------------------------------------------------------
# the public function and its gradient
# ----------------------------------------------------------------------------


class _QKRope(torch.autograd.Function):
    """q, k, v = qk_rope(...) on CUDA tensors, with the kernel backward.
    Inputs after the static ones: (source, qscale, kscale) per source, the
    scales already in the sources' dtype."""

    @staticmethod
    def forward(ctx, eps, num_heads, layout, cos, sin, *per_source):
        sources, qscales, kscales = per_source[0::3], per_source[1::3], per_source[2::3]
        q, k, v, rq, rk = qk_rope_fwd(sources, qscales, kscales, cos, sin, eps, num_heads,
                                      layout, with_rstd=True)
        ctx.save_for_backward(cos, sin, rq, rk, *per_source)
        ctx.num_heads, ctx.layout = num_heads, layout
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        cos, sin, rq, rk, *per_source = ctx.saved_tensors
        want_scale = any(ctx.needs_input_grad[6::3]) or any(ctx.needs_input_grad[7::3])
        grads, dscales = qk_rope_bwd(per_source[0::3], per_source[1::3], per_source[2::3],
                                     cos, sin, rq, rk, dq, dk, dv, ctx.num_heads, ctx.layout,
                                     want_scale)
        out = []
        for i, g in enumerate(grads):
            out += [g, *(dscales[2 * i:2 * i + 2] if want_scale else (None, None))]
        return (None, None, None, None, None, *out)


def qk_rope(sources, qscales, kscales, cos, sin, eps, num_heads, layout="bhsd"):
    """q, k, v of the joint sequence of ``sources`` (see the module
    docstring); CPU tensors run the plain version, CUDA tensors the kernels."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown layout {layout!r}")
    if not 1 <= len(sources) == len(qscales) == len(kscales) <= 2:
        raise ValueError("qk_rope takes one or two sources, each with its two scales")
    dev = sources[0].device
    if dev.type == "cpu":
        return qk_rope_reference(sources, qscales, kscales, cos, sin, eps, num_heads, layout)
    if dev.type != "cuda":
        raise ValueError(f"qk_rope runs on CPU or CUDA tensors, not {dev}")
    dtype = sources[0].dtype
    per_source = [t for x, qs, ks in zip(sources, qscales, kscales)
                  for t in (x, qs.to(dtype), ks.to(dtype))]
    if torch.is_grad_enabled() and any(t.requires_grad for t in per_source):
        return _QKRope.apply(eps, num_heads, layout, cos, sin, *per_source)
    return qk_rope_fwd(per_source[0::3], per_source[1::3], per_source[2::3], cos, sin, eps,
                       num_heads, layout)[:3]


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------


def _grid(rows, D, itemsize, sms):
    """Blocks of a launch: enough for every (batch, token, head) row at
    one row per 16-byte lane group, at most ``_BLOCKS_PER_SM`` a streaming
    multiprocessor (the kernels walk further rows in a grid-stride loop)."""
    lanes = D // (16 // itemsize)
    per_block = _THREADS // lanes
    return max(1, min(-(-rows // per_block), _BLOCKS_PER_SM * sms))


def _out_strides(t, layout):
    """Element strides of the (batch, head, token) axes under ``layout``."""
    if layout == "bshd":
        return t.stride(0), t.stride(2), t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _vectors_aligned(t, n):
    """A contiguous last axis, a 16-byte-aligned base, and every other stride
    a whole number of 16-byte vectors of ``n`` elements (sizes of one
    excepted: their stride is never stepped along)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % n == 0 for size, st in zip(t.shape[:-1], t.stride()[:-1])
                    if size > 1))


def _check_kernel_inputs(name, sources, qscales, kscales, cos, sin, num_heads):
    """Raise on anything the kernels do not take: a head dim outside
    32/64/128, sources that disagree or are not [q | k | v] of ``num_heads``
    heads, another dtype than bf16 or f32, tensors off one CUDA device, rows
    not made of whole 16-byte vectors, malformed tables or scales.  Returns
    (B, S, D, L0) and the (S, D) tables."""
    if not 1 <= len(sources) <= 2:
        raise ValueError(f"{name} takes one or two sources, got {len(sources)}")
    D = cos.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} takes head dim {SUPPORTED_HEAD_DIMS}, got {D}")
    x0 = sources[0]
    B, H = x0.shape[0], num_heads
    for x in sources:
        if x.ndim != 3 or x.shape[0] != B or x.shape[2] != 3 * H * D:
            raise ValueError(f"{name}: a source of shape {tuple(x.shape)} is not (B, L, 3HD) "
                             f"with B = {B}, H = {H}, D = {D}")
    S = sum(x.shape[1] for x in sources)
    if B * S * H >= 2**31:
        raise ValueError(f"{name}: {B} x {S} x {H} rows do not fit the kernels' int32 index")
    cos, sin = _tables(cos, sin, S)
    dtype, dev = x0.dtype, x0.device
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes bf16 or f32 sources, got {dtype}")
    every = (*sources, *qscales, *kscales, cos, sin)
    if any(t.device.type != "cuda" or t.device != dev for t in every):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    n = 16 // x0.element_size()
    for x in sources:
        if x.dtype != dtype or not _vectors_aligned(x, n):
            raise ValueError(f"{name}: sources must share a dtype and be rows of 16-byte "
                             f"vectors, got {x.dtype} strides {x.stride()}")
    for s in (*qscales, *kscales):
        if s.dtype != dtype or tuple(s.shape) != (D,) or not _vectors_aligned(s, n):
            raise ValueError(f"{name}: scales must be contiguous ({D},) in {dtype}")
    for t in (cos, sin):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: RoPE tables must be contiguous float32 (S, D)")
    return (B, S, D, sources[0].shape[1]), cos, sin


def _streams(sources, qscales, kscales):
    """The C functions' per-source pointers (a null second source) and the
    (batch, row) strides of both."""
    pad = [None] * (2 - len(sources))
    xs, qs, ks = ([*(t.data_ptr() for t in ts), *pad] for ts in (sources, qscales, kscales))
    strides = []
    for x in (*sources, *pad):
        strides += (x.stride(0), x.stride(1)) if x is not None else (0, 0)
    return xs, qs, ks, strides


def qk_rope_fwd(sources, qscales, kscales, cos, sin, eps, num_heads, layout="bhsd",
                with_rstd=False):
    """Launch the forward kernel: (q, k, v) in ``layout``, and with
    ``with_rstd`` the f32 (B, H, S) rsqrt of every q and k row (else None,
    None).  The scales must already be in the sources' dtype.  Raises on
    anything the kernel does not take."""
    (B, S, D, L0), cos, sin = _check_kernel_inputs("qk_rope_fwd", sources, qscales, kscales,
                                                  cos, sin, num_heads)
    x0, H = sources[0], num_heads
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    q, k, v = (torch.empty(shape, dtype=x0.dtype, device=x0.device) for _ in range(3))
    rq = rk = None
    if with_rstd:
        rq, rk = (torch.empty((B, H, S), dtype=torch.float32, device=x0.device)
                  for _ in range(2))
    xs, qs, ks, strides = _streams(sources, qscales, kscales)
    geom = (ctypes.c_int64 * 7)(*strides, *_out_strides(q, layout))
    grid = _grid(B * S * H, D, x0.element_size(), _sms(x0.device))
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = lib.qk_rope_fwd(_DTYPES[x0.dtype], D, xs[0], xs[1], qs[0], ks[0], qs[1], ks[1],
                              geom, cos.data_ptr(), sin.data_ptr(), q.data_ptr(),
                              k.data_ptr(), v.data_ptr(), _ptr(rq), _ptr(rk), B, H, S, L0,
                              float(eps), grid, stream)
    _raise_on("qk_rope_fwd", err)
    qk_rope_fwd.launches += 1
    return q, k, v, rq, rk


def qk_rope_bwd(sources, qscales, kscales, cos, sin, rq, rk, dq, dk, dv, num_heads,
                layout="bhsd", want_scale=False):
    """Launch the backward kernel: (d(source) for each source, contiguous,
    and, with ``want_scale``, [dq_scale0, dk_scale0, dq_scale1, dk_scale1]
    in the sources' dtype, else None).  ``rq``, ``rk``: the f32 (B, H, S)
    rsqrt of every row, as the forward stores it under autograd."""
    (B, S, D, L0), cos, sin = _check_kernel_inputs("qk_rope_bwd", sources, qscales, kscales,
                                                  cos, sin, num_heads)
    x0, H = sources[0], num_heads
    n = 16 // x0.element_size()
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    gs = []
    for i, g in enumerate((dq, dk, dv)):
        if tuple(g.shape) != shape or g.dtype != x0.dtype or g.device != x0.device:
            raise ValueError(f"qk_rope_bwd: gradient {i} is {g.dtype} {tuple(g.shape)}, "
                             f"not {x0.dtype} {shape}")
        gs.append(g if _vectors_aligned(g, n) else g.contiguous())
    for r in (rq, rk):
        if r.dtype != torch.float32 or tuple(r.shape) != (B, H, S) or not r.is_contiguous():
            raise ValueError("qk_rope_bwd: the stored rsqrt must be contiguous (B, H, S) f32")
    grads = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in sources]
    xs, qs, ks, strides = _streams(sources, qscales, kscales)
    geom = (ctypes.c_int64 * 13)(*strides, *(st for g in gs for st in _out_strides(g, layout)))
    grid = _grid(B * S * H, D, x0.element_size(), _sms(x0.device))
    part = dscale = None
    if want_scale:
        part = torch.empty((grid, 4, D), dtype=torch.float32, device=x0.device)
        dscale = torch.empty((4, D), dtype=torch.float32, device=x0.device)
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = lib.qk_rope_bwd(_DTYPES[x0.dtype], D, xs[0], xs[1], qs[0], ks[0], qs[1], ks[1],
                              geom, cos.data_ptr(), sin.data_ptr(), rq.data_ptr(),
                              rk.data_ptr(), *(g.data_ptr() for g in gs), grads[0].data_ptr(),
                              _ptr(grads[1] if len(grads) > 1 else None), _ptr(part),
                              _ptr(dscale), B, H, S, L0, grid, stream)
    _raise_on("qk_rope_bwd", err)
    qk_rope_bwd.launches += 1
    # d(scale) in the sources' dtype, as the eager product's gradient is
    dscales = None if dscale is None else list(dscale.to(x0.dtype).unbind(0))
    return grads, dscales


# every kernel wrapper, by the name its launches are reported under
KERNEL_WRAPPERS = {f.__name__: f for f in (qk_rope_fwd, qk_rope_bwd)}
for _f in KERNEL_WRAPPERS.values():
    _f.launches = 0


def reset_launches():
    for f in KERNEL_WRAPPERS.values():
        f.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library():
    lib = build.load(KERNEL)
    if lib.qk_rope_fwd.argtypes is None:
        ptr, i64s, i32, f32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, \
            ctypes.c_float
        lib.qk_rope_fwd.restype = lib.qk_rope_bwd.restype = i32
        lib.qk_rope_fwd.argtypes = ([i32, i32] + [ptr] * 6 + [i64s] + [ptr] * 7
                                    + [i32] * 4 + [f32, i32, ptr])
        lib.qk_rope_bwd.argtypes = ([i32, i32] + [ptr] * 6 + [i64s] + [ptr] * 11
                                    + [i32] * 5 + [ptr])
    return lib
