"""Wrapper of the RG-LRU scan kernel: the gates, the gated linear
recurrence and the product with the GeLU branch of one Griffin recurrent
block, in one launch (two kernels, the chunk summaries and the chunked
scan, counted as one; the scan alone when S is at most a chunk).

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/rglru_scan.cu`` on the current stream, or raise.  There is
no other route.  The wrapper allocates the output and the kernels'
(2, B, ceil(S / chunk) - 1, L) float32 summary scratch with
``torch.empty``; the chunk length is the built library's
(``rglru_scan_chunk``).  The grid depends on the shapes only and
nothing is read on the host, so a decode step (S = 1) that calls it can
be captured in a CUDA graph.

``rglru_scan_bwd`` is the backward: the gradients of all eight inputs
from the output's gradient, the last state's, and the h entering every
16 steps that ``rglru_scan_saving`` keeps, through ``csrc/rglru_scan_bwd.cu``
on the card (a chained scan and a reduce, one launch on its own counter;
``bwd_scratch_elems`` sizes its scratch) or ``ref.rglru_scan_bwd_ref`` on
the CPU.  ``rglru_scan_autograd`` (the
model's route while autograd records) runs the scan through an autograd
function over both; a direct CUDA call of ``rglru_scan`` whose input
requires a gradient raises (``kernels.refuse_grad``).

Fake tensors take a branch only they reach (``kernels.is_fake``): the
outputs, carries and scratch as fake tensors, at the chunk (``CHUNK``),
carry span (``CARRY``) and channel group (``GROUP``) of ``csrc/rglru.cuh``
and ``csrc/rglru_scan_bwd.cu``, and the shape-only operators
``repro_torch::rglru_scan`` and ``repro_torch::rglru_scan_bwd``, whose
FLOP formulas count ``FLOPS_PER_STEP`` (twice that backward) per (row,
step, channel).  DTensors run on each rank's batch rows and channel
shards (``kernels.on_shards``).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import LaunchCounter, is_fake, is_sharded, nvcc, on_shards, refuse_grad
from repro_torch.kernels.rglru_scan.ref import (
    rglru_scan_bwd_ref,
    rglru_scan_ref,
    rglru_scan_saving_ref,
)

__all__ = ["rglru_scan", "rglru_scan_saving", "rglru_scan_bwd", "rglru_scan_autograd",
           "bwd_scratch_elems", "chunk_len", "carry_len", "counter", "bwd_counter"]

counter = LaunchCounter("rglru_scan")
bwd_counter = LaunchCounter("rglru_scan_bwd")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The built kernels' constants (csrc/rglru.cuh: kChunk, kCarry;
# csrc/rglru_scan_bwd.cu: kGroup), which a fake trace cannot ask a library.
CHUNK, CARRY, GROUP = 64, 16, 32
# The arithmetic of one (row, step, channel): the two gates' multiply-adds
# (4), log a = -8 softplus(Lambda) r (2), sqrt(1 - a^2) (2), its product
# with i x (2), the recurrence a h + b (2) and the GeLU branch's product
# (1); transcendentals not counted.
FLOPS_PER_STEP = 13


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _scan_op(u: torch.Tensor, gpre: torch.Tensor, carry_spans: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::rglru_scan is the RG-LRU scan's shape-only operator: "
                       "it runs on fake tensors alone")


@_scan_op.register_fake
def _(u, gpre, carry_spans):
    b, _, width = u.shape
    return (torch.empty_like(u), u.new_empty((b, width), dtype=torch.float32),
            u.new_empty((b, carry_spans, width) if carry_spans else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _scan_flops(u_shape, *args, **kwargs) -> int:
    b, s, width = u_shape
    return FLOPS_PER_STEP * b * s * width


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _bwd_op(u: torch.Tensor, gpre: torch.Tensor, vecs: list[torch.Tensor],
            want_dh0: bool) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor],
                                     torch.Tensor]:
    raise RuntimeError("repro_torch::rglru_scan_bwd is the RG-LRU backward's shape-only "
                       "operator: it runs on fake tensors alone")


@_bwd_op.register_fake
def _(u, gpre, vecs, want_dh0):
    b, _, width = u.shape
    return (torch.empty_like(u), torch.empty_like(gpre), [torch.empty_like(v) for v in vecs],
            u.new_empty((b, width) if want_dh0 else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _bwd_flops(u_shape, *args, **kwargs) -> int:
    b, s, width = u_shape
    return 2 * FLOPS_PER_STEP * b * s * width


def _fake_scan(u, gpre, carries: bool):
    """The fake-tensor branch of the forward: (y, h_last, carries or None),
    with the chunk summaries as scratch beside them."""
    b, s, width = u.shape
    n_chunks = -(-s // CHUNK)
    scratch = (u.new_empty((2, b, n_chunks - 1, width), dtype=torch.float32)
               if n_chunks > 1 else None)
    y, h_last, saved = _scan_op(u, gpre, -(-s // CARRY) if carries else 0)
    del scratch
    counter.add_fake()
    return y, h_last, (saved if carries else None)


def _sharded(fn, u, gpre, vecs, h0):
    """``fn`` (``rglru_scan`` or ``rglru_scan_saving``) on each rank's batch
    rows and channel shards."""
    def local(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
        return fn(u, gpre, a_w, a_b, x_w, x_b, lam, h0)

    dims = ((0, 2), (0, 2)) + ((None, 0),) * 5
    outs = ((0, 2), (0, 1)) + (((0, 2),) if fn is rglru_scan_saving else ())
    if h0 is None:
        return on_shards(local, (u, gpre, *vecs), dims, outs)
    return on_shards(local, (u, gpre, *vecs, h0), dims + ((0, 1),), outs)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _entry():
    lib = nvcc.library("rglru_scan")
    fn = lib.rglru_scan
    fn.argtypes = [_P] * 12 + [_I] * 4 + [_P]
    fn.restype = _I
    lib.rglru_scan_chunk.restype = _I
    lib.rglru_scan_carry.restype = _I
    return lib, fn, lib.rglru_scan_chunk(), lib.rglru_scan_carry()


def _bwd_entry():
    lib = nvcc.library("rglru_scan_bwd")
    fn = lib.rglru_scan_bwd
    fn.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    fn.restype = _I
    for name in ("chunk", "carry", "group"):
        getattr(lib, f"rglru_scan_bwd_{name}").restype = _I
    return (lib, fn, lib.rglru_scan_bwd_chunk(), lib.rglru_scan_bwd_carry(),
            lib.rglru_scan_bwd_group())


def bwd_scratch_elems(b: int, s: int, width: int, chunk: int = 64, group: int = 32) -> int:
    """4-byte elements of the backward's scratch: per (batch, chunk,
    channel) the five vector gradients' partial sums and the w handed to
    the chunk on the left (float32), then a ticket counter per batch row
    and a flag per (batch, chunk, group of ``group`` channels) (int32)."""
    n_chunks = -(-s // chunk)
    return 6 * n_chunks * b * width + b + b * n_chunks * -(-width // group)


def chunk_len() -> int:
    """The chunk length of the built kernel library (built on first use)."""
    return _entry()[2]


def carry_len() -> int:
    """The steps between the carries ``rglru_scan_saving`` keeps on the card
    (the built library's; built on first use)."""
    return _entry()[3]


def _check(u, gpre, vecs, h0):
    if u.dim() != 3 or gpre.shape != u.shape:
        raise ValueError(f"u and gpre must be one (B, S, L) shape, got {tuple(u.shape)} "
                         f"and {tuple(gpre.shape)}")
    b, _, width = u.shape
    if u.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan takes float32 or bfloat16, got {u.dtype}")
    for x in (gpre,) + tuple(vecs):
        if x.dtype != u.dtype or x.device != u.device:
            raise ValueError(f"every input must be {u.dtype} on {u.device}, got "
                             f"{x.dtype} on {x.device}")
    if any(tuple(v.shape) != (width,) for v in vecs):
        raise ValueError(f"the gate vectors must be ({width},)")
    if h0 is not None and (tuple(h0.shape) != (b, width) or h0.dtype != torch.float32
                           or h0.device != u.device):
        raise ValueError(f"h0 must be ({b}, {width}) float32 on {u.device}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on CUDA or the CPU, not {u.device}")


def _launch(u, gpre, vecs, h0, carries):
    """The forward kernels on CUDA tensors: (y, h_last), and the carries
    written into ``carries`` unless it is None."""
    b, s, width = u.shape
    u, gpre = u.contiguous(), gpre.contiguous()
    vecs = [v.contiguous() for v in vecs]
    h0 = h0.contiguous() if h0 is not None else None
    y = torch.empty_like(u)
    h_last = torch.empty((b, width), dtype=torch.float32, device=u.device)
    lib, fn, chunk, _ = _entry()
    n_chunks = -(-s // chunk)
    scratch = None if n_chunks == 1 else torch.empty(
        (2, b, n_chunks - 1, width), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), gpre.data_ptr(), *[v.data_ptr() for v in vecs],
                 h0.data_ptr() if h0 is not None else None, y.data_ptr(), h_last.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 carries.data_ptr() if carries is not None else None, b, s, width,
                 _DTYPES[u.dtype], stream)
    counter.add()
    nvcc.check(lib, err, "rglru_scan")
    return y, h_last


def rglru_scan(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """One recurrent block's scan.  ``u`` (B, S, L) is the recurrence
    branch after its causal conv, ``gpre`` (B, S, L) the gate branch
    before its GeLU, both in the model's type; ``a_w``, ``a_b``, ``x_w``,
    ``x_b`` and ``lam`` (L,) the gate weights and biases and Lambda, in
    the model's type; ``h0`` (B, L) float32 the carried state or None
    (zeros).  Returns ``(h * gelu(gpre))`` (B, S, L) in the model's type
    and the last state ``h`` (B, L) in float32."""
    vecs = (a_w, a_b, x_w, x_b, lam)
    _check(u, gpre, vecs, h0)
    if is_sharded(u):
        return _sharded(rglru_scan, u, gpre, vecs, h0)
    if is_fake(u):
        return _fake_scan(u, gpre, False)[:2]
    if u.device.type == "cpu":
        return rglru_scan_ref(u, gpre, *vecs, h0)
    refuse_grad("rglru_scan", "train through rglru_scan_autograd (models.rglru), whose "
                "autograd function's backward is rglru_scan_bwd", u, gpre, *vecs, h0)
    return _launch(u, gpre, vecs, h0, None)


def rglru_scan_saving(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """The forward of the autograd function: ``rglru_scan``'s (y, h_last)
    and the carries (B, ceil(S / carry), L) float32, the h entering every
    ``carry_len()`` steps (h0 or 0 first), which the backward reads.  On
    the card one ``rglru_scan`` launch, on the CPU the plain loop."""
    vecs = (a_w, a_b, x_w, x_b, lam)
    _check(u, gpre, vecs, h0)
    if is_sharded(u):
        return _sharded(rglru_scan_saving, u, gpre, vecs, h0)
    if is_fake(u):
        return _fake_scan(u, gpre, True)
    if u.device.type == "cpu":
        return rglru_scan_saving_ref(u, gpre, *vecs, h0)
    b, s, width = u.shape
    carries = torch.empty((b, -(-s // carry_len()), width), dtype=torch.float32,
                          device=u.device)
    y, h_last = _launch(u, gpre, vecs, h0, carries)
    return y, h_last, carries


def rglru_scan_bwd(u, gpre, a_w, a_b, x_w, x_b, lam, carries, dy, dh_last=None,
                   want_dh0: bool = False):
    """The backward of ``rglru_scan``: (du, dgpre (B, S, L) in u's type;
    da_w, da_b, dx_w, dx_b, dlam (L,) in theirs; dh0 (B, L) float32, or
    None unless ``want_dh0``) from the output's gradient ``dy`` (B, S, L)
    in u's type, the last state's ``dh_last`` (B, L) float32 or None
    (zeros), and ``carries`` from ``rglru_scan_saving``.  On the card one
    launch of ``csrc/rglru_scan_bwd.cu`` (two kernels), which takes the
    carries at its library's carry span."""
    vecs = (a_w, a_b, x_w, x_b, lam)
    _check(u, gpre, vecs, None)
    b, s, width = u.shape
    if tuple(dy.shape) != (b, s, width) or dy.dtype != u.dtype or dy.device != u.device:
        raise ValueError(f"dy must be {u.dtype} {(b, s, width)} on {u.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if (carries.dim() != 3 or carries.shape[0] != b or carries.shape[2] != width
            or carries.dtype != torch.float32 or carries.device != u.device):
        raise ValueError(f"carries must be float32 ({b}, chunks, {width}) on {u.device}, got "
                         f"{carries.dtype} {tuple(carries.shape)} on {carries.device}")
    if dh_last is not None and (tuple(dh_last.shape) != (b, width)
                                or dh_last.dtype != torch.float32
                                or dh_last.device != u.device):
        raise ValueError(f"dh_last must be ({b}, {width}) float32 on {u.device}")
    if is_fake(u):
        scratch = u.new_empty((bwd_scratch_elems(b, s, width, CHUNK, GROUP),),
                              dtype=torch.float32)
        du, dgpre, dvecs, dh0 = _bwd_op(u, gpre, list(vecs), want_dh0)
        del scratch
        bwd_counter.add_fake()
        return (du, dgpre, *dvecs, dh0 if want_dh0 else None)
    if u.device.type == "cpu":
        grads = rglru_scan_bwd_ref(u, gpre, *vecs, dy, h0=carries[:, 0], dh_last=dh_last)
        return grads[:7] + (grads[7] if want_dh0 else None,)
    lib, fn, chunk, carry, group = _bwd_entry()
    if carries.shape[1] != -(-s // carry):
        raise ValueError(f"carries must hold {-(-s // carry)} spans of {carry} steps, got "
                         f"{carries.shape[1]}")
    ins = [t.contiguous() for t in (u, gpre, dy) + vecs]
    carries = carries.contiguous()
    dh_last = dh_last.contiguous() if dh_last is not None else None
    outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1])] + [
        torch.empty_like(v) for v in ins[3:]]
    dh0 = torch.empty((b, width), dtype=torch.float32, device=u.device) if want_dh0 else None
    scratch = torch.empty((bwd_scratch_elems(b, s, width, chunk, group),), dtype=torch.float32,
                          device=u.device)
    in_ptrs = (_P * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (_P * len(outs))(*(t.data_ptr() for t in outs))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(in_ptrs, carries.data_ptr(), dh_last.data_ptr() if dh_last is not None else None,
                 out_ptrs, dh0.data_ptr() if dh0 is not None else None, scratch.data_ptr(),
                 b, s, width, _DTYPES[u.dtype], stream)
    bwd_counter.add()
    nvcc.check(lib, err, "rglru_scan_bwd")
    return tuple(outs) + (dh0,)


class _RglruScan(torch.autograd.Function):
    """``rglru_scan`` forward (saving the carries), ``rglru_scan_bwd``
    backward; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, u, gpre, a_w, a_b, x_w, x_b, lam, h0):
        y, h_last, carries = rglru_scan_saving(u, gpre, a_w, a_b, x_w, x_b, lam, h0)
        ctx.save_for_backward(u, gpre, a_w, a_b, x_w, x_b, lam, carries)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, gpre, a_w, a_b, x_w, x_b, lam, carries = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.to(u.dtype)
        grads = rglru_scan_bwd(u, gpre, a_w, a_b, x_w, x_b, lam, carries, dy, dh_last,
                               want_dh0=ctx.has_h0 and ctx.needs_input_grad[7])
        return grads


def rglru_scan_autograd(u, gpre, a_w, a_b, x_w, x_b, lam, h0=None):
    """``rglru_scan`` whose gradient runs through ``rglru_scan_bwd``."""
    return _RglruScan.apply(u, gpre, a_w, a_b, x_w, x_b, lam, h0)
