"""The work of the hand-written kernels, from their shapes: the flops (by
the kind of unit that runs them) and the bytes each function needs, and the
least time an H100 could take for them.

One copy read by two callers: ``chip_smoke.py`` prices each kernel's bound
with it, and on the meta device the wrappers of flash attention, the SSD
scan, the sLSTM scan and AdamW report it (:func:`report`) to whatever counts the work of a step
(``launch/op_analysis.py``), since a kernel is no aten op that a counter of
the op stream could price.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

# dense peaks of the H100 SXM data sheet at 700 W
H100_BYTES_PER_S = 3.35e12               # HBM3
H100_HBM_BYTES = 80e9
H100_PEAK_FLOPS = {"float32": 67e12,     # float32 outside the tensor cores
                   "bfloat16": 989e12,   # tensor cores
                   "3xtf32": 495e12 / 3,  # TF32 tensor cores, 3 products each
                   # ... 2 each: a bfloat16 operand (exact in TF32, no low
                   # part) against a float32 one
                   "2xtf32": 495e12 / 2,
                   # the special function units (exp2, reciprocal, ...): 16
                   # a clock an SM (CUDA guide, compute capability 9.0), at
                   # the 1.98 GHz at which 132 SMs give float32's 67e12
                   "sfu": 132 * 16 * 1.98e9}
# The network a collective crosses: one 400 Gb/s NDR InfiniBand NIC per H100
# of an HGX node, 50e9 bytes/s a device.  One rate for every mesh axis: the
# production meshes put 16 consecutive ranks on "model" and 256 or 512 in
# all, so every axis spans more than one node's 8-card NVLink domain and its
# ring runs at the NIC's rate; NVLink 4's 450 GB/s a direction would
# understate the time.  (The counterpart of the reference's one ICI_BW.)
H100_NET_BYTES_PER_S = 50e9


def bound(flops: dict, nbytes) -> tuple[float, str]:
    """The least time the card could take: the longest of the bytes at the
    memory rate and, for each key of H100_PEAK_FLOPS in ``flops``, its
    operations at that peak (the kinds run on separate units).  Returns
    (ms, "operations" or "bytes")."""
    t_ops = max((f / H100_PEAK_FLOPS[kind] for kind, f in flops.items()),
                default=0.0)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_work(b, hq, hkv, s, t, d, dtype, causal=True):
    """(flops, bytes) the attention function needs on these shapes: 4*D
    flops per live (query, key) pair; q, k, v read once, o written once."""
    if causal:                       # row i sees keys 0 .. i + T - S
        pairs = s * (t - s) + s * (s + 1) // 2
    else:
        pairs = s * t
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * t * d) * dtype.itemsize
    return flops, nbytes


def attention_bwd_work(b, hq, hkv, s, t, d, dtype, causal=True):
    """(flops, bytes) of attention's backward: the 5 products of its live
    (query, key) pairs that the function needs (Q K^T, dO V^T, P^T dO,
    dS^T Q, dS K), 2 D flops a pair each; q, k, v, o and dO read once, dq,
    dk and dv written once."""
    flops, _ = attention_work(b, hq, hkv, s, t, d, dtype, causal)
    nbytes = (4 * b * hq * s * d + 4 * b * hkv * t * d) * dtype.itemsize
    return 5 * flops // 2, nbytes


def _tensor_kinds(dtype):
    """The kinds at which the SSD kernels' tensor-core products are priced
    on inputs of ``dtype``: (two float32 operands or, in bfloat16, two
    inputs; one input against a float32 value).  float32's accuracy on
    float32 operands is 3xTF32's; a bfloat16 input is exact in TF32, so a
    product of one against a float32 value needs 2 TF32 products, and one
    of two inputs is a bfloat16 product with a float32 accumulator."""
    return ("3xtf32", "3xtf32") if dtype.itemsize == 4 else (
        "bfloat16", "2xtf32")


def _add(flops: dict, kind: str, n: int) -> None:
    if n:
        flops[kind] = flops.get(kind, 0) + n


def ssd_work(b, s, h, d, n, dtype, narrow_d):
    """(flops by kind, bytes) the SSD scan needs at the kernel's chunk
    length L.  Per chunk of l tokens, over the l (l + 1) / 2 live (t, u)
    pairs of the causal triangle: C . B^T once per batch (b and c are
    shared by the heads), on the tensor cores, and the decay of each pair
    per (batch, head), float32 FMAs; per (batch, head) G @ x, and C . h^T
    and the state update over l x D x N each, on the tensor cores where
    the kernel puts them there (D >= ``narrow_d``), else FMAs.  Each
    tensor-core product at its kind (``_tensor_kinds``: in float32
    3xTF32; in bfloat16 C . B^T, two inputs, a bfloat16 product, and the
    rest, an input against a float32 value, 2xTF32).  x, a, b, c read
    once, y written once."""
    from .ssd_scan import CHUNK
    both, one = _tensor_kinds(dtype)
    cb = decay = mma = 0
    for t0 in range(0, s, CHUNK):
        ln = min(CHUNK, s - t0)
        pairs = ln * (ln + 1) // 2
        cb += b * 2 * pairs * n
        decay += b * h * pairs
        mma += b * h * (2 * pairs * d + 4 * ln * d * n)
    flops: dict = {}
    _add(flops, "float32", decay + (0 if d >= narrow_d else mma))
    _add(flops, both, cb)
    _add(flops, one, mma if d >= narrow_d else 0)
    nbytes = (2 * b * s * h * d + b * s * h + 2 * b * s * n) * dtype.itemsize
    return flops, nbytes


def ssd_bwd_work(b, s, h, d, n, dtype, kept: bool):
    """(flops by kind, bytes) the SSD scan's backward needs at the chunk
    length L, with C . B^T, Acum and h_c ``kept`` from the forward's
    scratch, or else computed again.  Per chunk of l tokens, over its l (l
    + 1) / 2 live (t, u) pairs: the decay of each pair per (batch, head),
    FMAs, and, computed again, C . B^T per batch; per (batch, head) the
    four pair products G^T dy, M = dy x^T, M B and M^T C, and the l x D x
    N products: the dual's local states and the carries B R, dy h^T and x
    R^T, and computed again the forward's local states.  The products at
    the least time at float32's accuracy (``_tensor_kinds``: 3xTF32 in
    float32; in bfloat16 C . B^T and M = dy x^T, two inputs, a bfloat16
    product, the rest, an input against a float32 value, 2xTF32;
    ``fma_bound_ms`` prices them all at the FMA peak).  x, a, b, c, y and
    dy read once, and the kept scratch (float32); dx, da, db and dc
    written once."""
    from .ssd_scan import CHUNK, scratch_floats
    both, one = _tensor_kinds(dtype)
    decay = two = mixed = 0
    for t0 in range(0, s, CHUNK):
        ln = min(CHUNK, s - t0)
        pairs = ln * (ln + 1) // 2
        decay += b * h * pairs
        two += b * h * 2 * pairs * d + (0 if kept else b * 2 * pairs * n)
        mixed += b * h * (2 * pairs * d + 4 * pairs * n
                          + (8 if kept else 10) * ln * d * n)
    flops: dict = {"float32": decay}
    _add(flops, both, two)
    _add(flops, one, mixed)
    nbytes = (4 * b * s * h * d + 2 * b * s * h + 4 * b * s * n) * (
        dtype.itemsize)
    if kept:
        nbytes += 4 * scratch_floats(b, s, h, d, n)
    return flops, nbytes


def slstm_work(b, s, d, dtype, keep: bool):
    """(flops by kind, bytes) of the sLSTM recurrence's forward over B x S
    steps of d units.  Per (b, t, unit) 20 float32 flops (the four
    pre-activations' FMAs, the stabilizer's add and max, the exponents'
    subtractions, c' and n', |n'| max 1, o c') and 6 special-function
    operations (three exps, tanh, two reciprocals: sigmoid's and the
    division).  gx read once, r and the carry read once, hs and the last
    carry written once: the function's bytes.  With ``keep`` also the
    carry after every step (c, n, m), which the kernel writes for its
    backward: its own traffic, which the meta path reports, but no byte
    the function needs, so a bound prices ``keep=False``."""
    steps = b * s * d
    nbytes = (4 * steps + 4 * d + 8 * b * d + steps
              + (3 * steps if keep else 0)) * dtype.itemsize
    return {"float32": 20 * steps, "sfu": 6 * steps}, nbytes


def slstm_bwd_work(b, s, d, dtype, kept: bool):
    """(flops by kind, bytes) of the recurrence's backward, with hs and the
    carry after every step (c, n, m) ``kept`` by the forward, which the
    kernel reads, or else computed again from the initial carry (the
    forward's carry at a checkpoint every few hundred steps, a negligible
    read, each segment's forward run again on gx read once and held on
    chip).  Per (b, t, unit) either way the forward's step again (20
    flops, 6 special-function operations: the kernel too computes a step's
    gates again from the carry it started from) and its reverse (~40
    flops: the gradients of h', c', n', the exps and the max, the four
    pre-activations' and dr's terms, and the carried dh; one more
    reciprocal).  gx and dhs read once, r, the initial carry and the last
    carry's gradient read once, and with ``kept`` hs and the kept carry;
    dgx, dr and the initial carry's gradient written once."""
    steps = b * s * d
    nbytes = (4 * steps + steps + 4 * d + 8 * b * d
              + 4 * steps + 4 * d + 4 * b * d
              + (4 * steps if kept else 0)) * dtype.itemsize
    return {"float32": 60 * steps, "sfu": 7 * steps}, nbytes


def adamw_work(n, param_dtype, grad_dtype, master: bool):
    """(flops, bytes) of one leaf's AdamW update over n parameters: no
    flops (the dry-run counts products only, as the reference's HLO
    analysis counts dots only; the update's ~10 float32 operations a
    parameter are far below the card's ridge); g read once, m, v and the
    float32 weight read and written once, and with a ``master`` copy the
    param of ``param_dtype`` written once."""
    nbytes = n * (grad_dtype.itemsize + 6 * 4
                  + (param_dtype.itemsize if master else 0))
    return {}, nbytes


def adamw_norm_work(grads):
    """(flops, bytes) of the gradient norm over ``grads``, (numel, dtype)
    pairs: no flops; each gradient read once, the float32 norm written."""
    return {}, sum(n * dtype.itemsize for n, dtype in grads) + 4


# -- the meta path's report -----------------------------------------------------

_SINKS: list[list] = []


@contextlib.contextmanager
def collect() -> Iterator[list]:
    """Within the block, every :func:`report` appends ``(kernel, flops by
    kind, bytes)`` to the list this yields."""
    sink: list = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def report(kernel: str, flops: dict, nbytes: int) -> None:
    """One kernel call's work, as the meta path of its wrapper reports it
    in place of a launch."""
    for sink in _SINKS:
        sink.append((kernel, dict(flops), int(nbytes)))

