"""A-FADMM-CS: count-sketch compression for large models (paper §6).
Counterpart of ``repro/core/sketch.py``.

The paper's "Large Models" extension transmits a *compressed* update.  The
codec is a count sketch (a random bucket and a random sign per element): a
linear O(d) encoder with no dense d × d_s matrix, unbiased under the
transposed-sketch decoder.  :class:`SketchPlan` stores its buckets and
signs; the hashed codec that the LLM trainer's ``sketched`` mode runs
generates them from the element's index (``_hash_u32``), so nothing of
the model's size is stored.

The reference hashes in ``uint32``.  Torch has no right shift on
``uint32``, so the hash runs in int64, masked to 32 bits after each
multiply and add: the low 32 bits of an int64 product are right even where
the product wraps past 2⁶³, and only masked, non-negative values are
shifted.  An element index ≥ 2³² hashes as its value mod 2³², as the
reference's ``uint32`` index does (granite-8b's D = 8,053,362,688 wraps
inside ``layers.mlp.gate``).

The encode is a scatter-add (``index_add_``) into an f32 (d_s,) buffer,
as the reference's ``segment_sum`` is.  On the card it is float atomics,
so the order of a bucket's sum is not fixed: card, CPU and the reference
agree to a tolerance, not to the bit.  The
packed codec takes a leaf, or a chunk of one, with its offset in the
packed index space (:func:`encode_packed`, :func:`decode_packed`), so
:func:`encode_chunked` encodes a whole tree a chunk of :data:`CHUNK`
elements at a time and never builds a (D,) buffer.

The shard-local codec (``encode_shard_local``/``decode_shard_local``)
takes a shard's canonical indices and validity mask
(``core.packing.shard_perm_local``/``shard_valid_mask`` make them): the
sketched mode on a mesh (``train.llm_trainer.make_sketched(mesh=)``)
encodes each rank's resident slice with it, a chunk at a time, and sums
the partial sketches over the shard grid; each rank decodes its own
coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
_HASH_A = 0x9E3779B1            # golden-ratio odd constant
_HASH_B = 0x85EBCA77
_HASH_C = 0xCA87C3E5

#: elements a chunk of the chunked codec: its int64 index, bucket and sign
#: temporaries stay near 1.5 GB
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class SketchPlan:
    """Static count-sketch: d -> d_s buckets with random signs."""

    d: int
    d_s: int
    bucket: Tensor   # (d,) int64 in [0, d_s)
    sign: Tensor     # (d,) float32 in {-1, +1}

    @classmethod
    def build(cls, gen: torch.Generator, d: int, d_s: int) -> "SketchPlan":
        """Buckets uniform in [0, d_s) and Bernoulli(½) signs from ``gen``
        (on its device)."""
        dev = gen.device
        bucket = torch.randint(0, d_s, (d,), generator=gen, device=dev)
        bits = torch.rand((d,), generator=gen, device=dev) < 0.5
        sign = 2.0 * bits.to(torch.float32) - 1.0
        return cls(d=d, d_s=d_s, bucket=bucket, sign=sign)

    @classmethod
    def from_planes(cls, bucket: Tensor, sign: Tensor, d_s: int
                    ) -> "SketchPlan":
        """A plan of given buckets and signs (the JAX package's, say)."""
        return cls(d=int(bucket.shape[0]), d_s=d_s, bucket=bucket.long(),
                   sign=sign.to(torch.float32))


def _scatter(signed: Tensor, bucket: Tensor, d_s: int,
             out: Optional[Tensor]) -> Tensor:
    """Σ of ``signed``'s (..., n) entries into their buckets of a
    (..., d_s) f32 buffer (``out``, accumulated into, or a new one)."""
    if out is None:
        out = torch.zeros(signed.shape[:-1] + (d_s,), dtype=torch.float32,
                          device=signed.device)
    return out.index_add_(-1, bucket, signed)


def encode(plan: SketchPlan, v: Tensor) -> Tensor:
    """S v: (..., d) -> (..., d_s).  Linear, O(d)."""
    return _scatter(v * plan.sign, plan.bucket, plan.d_s, None)


def decode(plan: SketchPlan, s: Tensor) -> Tensor:
    """Sᵀ s: an unbiased estimate of v up to bucket-collision noise."""
    return s[..., plan.bucket] * plan.sign


def encode_decode_gain(plan: SketchPlan) -> float:
    """Expected ‖decode(encode(v))‖²/‖v‖² energy inflation ≈ 1 + d/d_s."""
    return 1.0 + plan.d / plan.d_s


# ---------------------------------------------------------------------------
# the hashed (storage-free) codec
# ---------------------------------------------------------------------------

def _hash_u32(i: Tensor, seed: int) -> Tensor:
    """The reference's multiply-shift hash of uint32 indices, in int64:
    ``i`` mod 2³² in, a value in [0, 2³²) out."""
    x = torch.bitwise_and(i.long(), _MASK32)
    x.mul_(_HASH_A).add_((seed * _HASH_B) & _MASK32).bitwise_and_(_MASK32)
    t = torch.bitwise_right_shift(x, 15)
    x.bitwise_xor_(t)
    x.mul_(_HASH_C).bitwise_and_(_MASK32)
    torch.bitwise_right_shift(x, 13, out=t)
    return x.bitwise_xor_(t)


def _flat_index(shape, offset: int = 0, device=None) -> Tensor:
    """Row-major element index of every position of ``shape``, shifted by
    ``offset``, mod 2³² (int64)."""
    n = 1
    for s in shape:
        n *= s
    base = offset & _MASK32
    idx = torch.arange(base, base + n, dtype=torch.int64, device=device)
    return idx.bitwise_and_(_MASK32).reshape(tuple(shape))


def bucket_of(idx: Tensor, d_s: int, seed: int) -> Tensor:
    """Bucket (int64 in [0, d_s)) of canonical packed indices, taken mod
    2³² as the reference's ``uint32``: whoever holds an element's canonical
    index encodes it against the same global codec."""
    return _hash_u32(idx, seed).remainder_(d_s)


def sign_of(idx: Tensor, seed: int) -> Tensor:
    bit = torch.bitwise_right_shift(_hash_u32(idx, seed + 101), 7)
    return 2.0 * bit.bitwise_and_(1).to(torch.float32) - 1.0


def hashed_bucket(shape, d_s: int, seed: int, offset: int = 0,
                  device=None) -> Tensor:
    """Buckets of a leaf that starts at packed offset ``offset``: element i
    hashes as global index ``offset + i``, so leafwise encodes compose
    into one global codec (:func:`encode_packed`)."""
    return bucket_of(_flat_index(shape, offset, device), d_s, seed)


def hashed_sign(shape, seed: int, offset: int = 0, device=None) -> Tensor:
    return sign_of(_flat_index(shape, offset, device), seed)


def encode_hashed(v: Tensor, d_s: int, seed: int, offset: int = 0) -> Tensor:
    """(any shape) -> (d_s,) count sketch with hash-generated buckets and
    signs."""
    idx = _flat_index(tuple(v.shape), offset, v.device)
    signed = v.float() * sign_of(idx, seed)
    return _scatter(signed.reshape(-1), bucket_of(idx, d_s, seed).reshape(-1),
                    d_s, None)


def decode_hashed(s: Tensor, shape, seed: int, offset: int = 0) -> Tensor:
    """(d_s,) -> (shape) transposed-sketch (unbiased) estimate."""
    if isinstance(shape, int):
        shape = (shape,)
    idx = _flat_index(tuple(shape), offset, s.device)
    return s[bucket_of(idx, s.shape[-1], seed)] * sign_of(idx, seed)


def encode_shard_local(v: Tensor, idx: Tensor, valid: Tensor, d_s: int,
                       seed: int, out: Optional[Tensor] = None) -> Tensor:
    """One shard's (..., m) resident packed slice -> its (..., d_s) partial
    global count sketch, added into ``out`` when given.  ``idx``: the (m,)
    canonical packed index of each position; ``valid``: the (m,) mask that
    zeroes layout padding.  The partial sketches of all shards sum to the
    global encode."""
    signed = v.float() * sign_of(idx, seed) * valid.to(torch.float32)
    return _scatter(signed, bucket_of(idx, d_s, seed), d_s, out)


def decode_shard_local(s: Tensor, idx: Tensor, valid: Tensor,
                       seed: int) -> Tensor:
    """(..., d_s) global sketch -> one shard's (..., m) resident estimate;
    padding decodes to 0."""
    out = s[..., bucket_of(idx, s.shape[-1], seed)] * sign_of(idx, seed)
    return out * valid.to(out.dtype)


# ---------------------------------------------------------------------------
# the packed (global) hashed codec
# ---------------------------------------------------------------------------

def _codec(n: int, d_s: int, seed: int, offset: int,
           device) -> Tuple[Tensor, Tensor]:
    idx = _flat_index((n,), offset, device)
    return bucket_of(idx, d_s, seed), sign_of(idx, seed)


def packed_bucket(n: int, d_s: int, seed: int, offset: int = 0,
                  device=None) -> Tensor:
    """Bucket of packed elements [offset, offset + n): (n,) in [0, d_s)."""
    return hashed_bucket((n,), d_s, seed, offset, device)


def packed_sign(n: int, seed: int, offset: int = 0, device=None) -> Tensor:
    return hashed_sign((n,), seed, offset, device)


def encode_packed(v: Tensor, d_s: int, seed: int, offset: int = 0,
                  out: Optional[Tensor] = None) -> Tensor:
    """(..., n) packed slice starting at ``offset`` -> (..., d_s) global
    count sketch, added into ``out`` when given."""
    bucket, sign = _codec(v.shape[-1], d_s, seed, offset, v.device)
    return _scatter(v.float() * sign, bucket, d_s, out)


def decode_packed(s: Tensor, n: int, seed: int, offset: int = 0) -> Tensor:
    """(..., d_s) -> (..., n) transposed-sketch estimate of the packed slice
    starting at ``offset``."""
    bucket, sign = _codec(n, s.shape[-1], seed, offset, s.device)
    return s[..., bucket] * sign


def chunks(n: int, chunk: int = CHUNK) -> Iterable[Tuple[int, int]]:
    """(start, stop) of consecutive pieces of at most ``chunk`` of n."""
    for a in range(0, n, chunk):
        yield a, min(a + chunk, n)


def encode_chunked(leaves: Iterable[Tensor], d_s: int, seed: int,
                   out: Optional[Tensor] = None,
                   chunk: int = CHUNK) -> Tensor:
    """The global (d_s,) sketch of the packed buffer of ``leaves`` (in
    packed order, each flattened), encoded leaf by leaf and ``chunk``
    elements at a time at their packed offsets: no buffer of the packed
    size is built.  Equals :func:`encode_packed` of the packed buffer up
    to the order of each bucket's sum."""
    off = 0
    for leaf in leaves:
        flat = leaf.reshape(-1)
        for a, b in chunks(flat.shape[0], chunk):
            out = encode_packed(flat[a:b], d_s, seed, off + a, out=out)
        off += flat.shape[0]
    if out is None:
        raise ValueError("encode_chunked: no leaves")
    return out
