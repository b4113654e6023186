"""Packed-buffer pytree transport: flatten a parameter tree into ONE
contiguous ``(..., D)`` f32 buffer so the whole OTA uplink is a single
kernel chain per round instead of one per leaf.  Counterpart of the
single-device half of ``repro/core/packing.py``.

A :class:`PackSpec` holds per-leaf offsets and sizes in the packed vector,
plus the shapes and dtypes needed to unpack the received global model.
Leaves are visited in ``jax.tree_util``'s order (dict keys sorted,
recursively; ``repro_torch.tree``), so offsets, sizes and packed buffers
equal the JAX package's for the same tree.

Leaves may carry leading batch dims (the worker axis ``W``): a leaf of shape
``lead + spec.shapes[i]`` packs into ``lead + (sizes[i],)``; all leaves of
one ``pack`` call share ``lead``.  Complex trees (duals λ, fading h) pack
planewise via :func:`pack_cplx` / :func:`unpack_cplx`.

Shard-local packing (:class:`ShardPackSpec`) is the model-parallel layout:
every rank of a (fsdp, model) shard grid packs only the leaf shards it
holds, and the global packed buffer is the concatenation of the per-shard
packs (fsdp-major), so packing and unpacking move no data between ranks.
:func:`shard_perm` maps each shard-packed position to its canonical
:class:`PackSpec` index.  The layout math is the JAX package's, function
for function; a shard's index is a host int here (each rank knows its own),
where JAX traces ``axis_index``.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.cplx import Complex
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Tensor = torch.Tensor
PyTree = Any


class PackSpec(NamedTuple):
    """Static layout of a tree inside a flat packed buffer."""

    treedef: Any                          # tree structure (Complex = leaf)
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf element shape (no batch dims)
    dtypes: Tuple[Any, ...]               # per-leaf dtype (for bit-compatible unpack)
    offsets: Tuple[int, ...]              # start of each leaf in the packed axis
    sizes: Tuple[int, ...]                # elements per leaf
    d: int                                # total packed length Σ sizes

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)


def build_packspec(tree: PyTree, batch_dims: int = 0) -> PackSpec:
    """Layout of ``tree``'s leaves (skipping ``batch_dims`` leading axes,
    e.g. 1 for worker-major ``(W, ...)`` trees) inside one packed vector."""
    leaves, treedef = tree_flatten(tree)
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        t = leaf.re if isinstance(leaf, Complex) else leaf
        eshape = tuple(t.shape[batch_dims:])
        size = math.prod(eshape)
        shapes.append(eshape)
        dtypes.append(t.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size
    return PackSpec(treedef=treedef, shapes=tuple(shapes),
                    dtypes=tuple(dtypes), offsets=tuple(offsets),
                    sizes=tuple(sizes), d=off)


def _lead(spec: PackSpec, leaf: Tensor, i: int) -> Tuple[int, ...]:
    nb = leaf.dim() - len(spec.shapes[i])
    if nb < 0 or tuple(leaf.shape[nb:]) != spec.shapes[i]:
        raise ValueError(
            f"leaf {i} shape {tuple(leaf.shape)} does not end with spec "
            f"shape {spec.shapes[i]}")
    return tuple(leaf.shape[:nb])


def pack(spec: PackSpec, tree: PyTree) -> Tensor:
    """``tree`` -> ``lead + (spec.d,)`` f32 buffer (row-major per leaf).
    Each leaf is cast and copied once into the buffer, with no f32 copy of
    the leaf on the side."""
    leaves = tree_flatten(tree)[0]
    if len(leaves) != spec.n_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                         f"{spec.n_leaves}")
    lead = _lead(spec, leaves[0], 0)
    buf = torch.empty(lead + (spec.d,), dtype=torch.float32,
                      device=leaves[0].device)
    for i, leaf in enumerate(leaves):
        li = _lead(spec, leaf, i)
        if li != lead:
            raise ValueError(f"leaf {i} leading dims {li} != leaf 0 leading "
                             f"dims {lead}")
        off, n = spec.offsets[i], spec.sizes[i]
        buf[..., off:off + n].copy_(leaf.reshape(lead + (n,)))
    return buf


def unpack(spec: PackSpec, buf: Tensor, cast: bool = True) -> PyTree:
    """``lead + (spec.d,)`` buffer -> tree of views into it; ``cast=True``
    restores the recorded leaf dtypes (a copy where the dtype differs),
    ``cast=False`` keeps the buffer dtype (the analog path's f32)."""
    if buf.shape[-1] != spec.d:
        raise ValueError(f"buffer last dim {buf.shape[-1]} != spec.d {spec.d}")
    lead = tuple(buf.shape[:-1])
    out = []
    for i in range(spec.n_leaves):
        off, n = spec.offsets[i], spec.sizes[i]
        piece = buf[..., off:off + n].reshape(lead + spec.shapes[i])
        out.append(piece.to(spec.dtypes[i]) if cast else piece)
    return tree_unflatten(spec.treedef, out)


def pack_cplx(spec: PackSpec, tree: PyTree) -> Complex:
    """Complex-leaf tree -> Complex of packed planes."""
    return Complex(pack(spec, tree_map(lambda c: c.re, tree)),
                   pack(spec, tree_map(lambda c: c.im, tree)))


def unpack_cplx(spec: PackSpec, buf: Complex) -> PyTree:
    """Complex packed planes -> tree of Complex leaves (f32 views: duals and
    fading always live in f32, never the parameter dtype)."""
    re = tree_flatten(unpack(spec, buf.re, cast=False))[0]
    im = tree_flatten(unpack(spec, buf.im, cast=False))[0]
    return tree_unflatten(spec.treedef,
                          [Complex(r, i) for r, i in zip(re, im)])


# ---------------------------------------------------------------------------
# shard-local packing (model-parallel / fsdp meshes)
# ---------------------------------------------------------------------------

class ShardPackSpec(NamedTuple):
    """Static layout of a tree packed per (fsdp, model) shard.

    The grid holds ``n_fsdp x n_model`` shards, flattened fsdp-major: shard
    ``j = jf * n_model + jm`` owns ``[j*d_local, (j+1)*d_local)`` of the
    global ``d_pad``-wide packed axis.  A leaf falls in one of four
    ownership classes by which of its element dims the grid shards:

    * **A**: model and fsdp dims both set; the resident block packs at
      ``local_offsets[i]``;
    * **B**: model dim only; the per-model-shard flats concatenate into a B
      segment of ``b_size`` elements, zero-padded to ``n_fsdp * b_chunk``
      and split over the fsdp shards;
    * **C**: fsdp dim only; a per-fsdp-shard segment of ``c_size`` elements
      split over the model shards;
    * **D**: replicated on both; one global segment of ``rep_size``
      elements split over all ``n_shards`` shards.

    Per shard: ``[A blocks | B chunk | C chunk | D chunk]``.  Every element
    is owned by exactly one shard.  ``n_fsdp == 1`` is the 1-D
    model-sharded layout, and a 1 x 1 grid is :class:`PackSpec`'s layout
    (every leaf in D, in leaf order).
    """

    spec: PackSpec                          # canonical global layout
    n_model: int                            # model-axis shards
    n_fsdp: int                             # fsdp-axis shards
    shard_dims: Tuple[Optional[int], ...]   # per-leaf model-sharded elem dim
    fsdp_dims: Tuple[Optional[int], ...]    # per-leaf fsdp-sharded elem dim
    local_offsets: Tuple[Optional[int], ...]  # class-A leaves: offset in shard
    a_local: int                            # elements of class-A leaves/shard
    b_leaves: Tuple[int, ...]               # class-B (model-only) leaf idxs
    b_offsets: Tuple[int, ...]              # offsets in the B segment
    b_size: int                             # B segment width per model shard
    b_chunk: int                            # ceil(b_size / n_fsdp)
    c_leaves: Tuple[int, ...]               # class-C (fsdp-only) leaf idxs
    c_offsets: Tuple[int, ...]              # offsets in the C segment
    c_size: int                             # C segment width per fsdp shard
    c_chunk: int                            # ceil(c_size / n_model)
    rep_leaves: Tuple[int, ...]             # class-D (replicated) leaf idxs
    rep_offsets: Tuple[int, ...]            # their offsets in the D segment
    rep_size: int                           # R: real replicated elements
    rep_chunk: int                          # ceil(R / n_shards)

    @property
    def n_shards(self) -> int:
        return self.n_model * self.n_fsdp

    @property
    def b_start(self) -> int:
        return self.a_local

    @property
    def c_start(self) -> int:
        return self.a_local + self.b_chunk

    @property
    def sharded_local(self) -> int:
        """Start of the D chunk: the non-replicated elements per shard."""
        return self.a_local + self.b_chunk + self.c_chunk

    @property
    def d_local(self) -> int:
        return self.sharded_local + self.rep_chunk

    @property
    def d_pad(self) -> int:
        return self.n_shards * self.d_local

    @property
    def b_pad(self) -> int:
        return self.n_fsdp * self.b_chunk

    @property
    def c_pad(self) -> int:
        return self.n_model * self.c_chunk

    @property
    def rep_pad(self) -> int:
        return self.n_shards * self.rep_chunk

    @property
    def has_padding(self) -> bool:
        return (self.b_pad != self.b_size or self.c_pad != self.c_size
                or self.rep_pad != self.rep_size)


def build_shard_packspec(tree: PyTree, shard_dims: Sequence[Optional[int]],
                         n_shards: int, batch_dims: int = 0, *,
                         fsdp_dims: Optional[Sequence[Optional[int]]] = None,
                         n_fsdp: int = 1) -> ShardPackSpec:
    """Shard-local layout of ``tree`` from each leaf's model-sharded element
    dim (None: replicated over the model axis) and its fsdp-sharded one.
    Both align with the flatten order; ``n_shards`` is the model-axis shard
    count (the JAX name), and a sharded dim must divide by its axis size.
    ``n_fsdp == 1`` makes ``fsdp_dims`` all None."""
    spec = build_packspec(tree, batch_dims=batch_dims)
    n_model = n_shards
    if len(shard_dims) != spec.n_leaves:
        raise ValueError(f"shard_dims has {len(shard_dims)} entries, tree "
                         f"has {spec.n_leaves} leaves")
    if fsdp_dims is None or n_fsdp == 1:
        fsdp_dims = (None,) * spec.n_leaves
    if len(fsdp_dims) != spec.n_leaves:
        raise ValueError(f"fsdp_dims has {len(fsdp_dims)} entries, tree "
                         f"has {spec.n_leaves} leaves")
    local_offsets: List[Optional[int]] = []
    b_leaves, b_offsets = [], []
    c_leaves, c_offsets = [], []
    rep_leaves, rep_offsets = [], []
    a_off = b_off = c_off = r_off = 0

    def _check(i, dim, n, axis_name):
        eshape = spec.shapes[i]
        if not (0 <= dim < len(eshape)):
            raise ValueError(f"leaf {i}: {axis_name} dim {dim} out of range "
                             f"for shape {eshape}")
        if eshape[dim] % n:
            raise ValueError(f"leaf {i}: dim {dim} of {eshape} not "
                             f"divisible by {n} {axis_name} shards")

    for i, (md, fd) in enumerate(zip(shard_dims, fsdp_dims)):
        if md is not None:
            _check(i, md, n_model, "model")
        if fd is not None:
            _check(i, fd, n_fsdp, "fsdp")
        if md is not None and fd is not None:
            if md == fd:
                raise ValueError(f"leaf {i}: model and fsdp shard the same "
                                 f"dim {md}")
            local_offsets.append(a_off)
            a_off += spec.sizes[i] // (n_model * n_fsdp)
        elif md is not None:
            local_offsets.append(None)
            b_leaves.append(i)
            b_offsets.append(b_off)
            b_off += spec.sizes[i] // n_model
        elif fd is not None:
            local_offsets.append(None)
            c_leaves.append(i)
            c_offsets.append(c_off)
            c_off += spec.sizes[i] // n_fsdp
        else:
            local_offsets.append(None)
            rep_leaves.append(i)
            rep_offsets.append(r_off)
            r_off += spec.sizes[i]
    b_chunk = -(-b_off // n_fsdp) if b_off else 0
    c_chunk = -(-c_off // n_model) if c_off else 0
    rep_chunk = -(-r_off // (n_model * n_fsdp)) if r_off else 0
    return ShardPackSpec(spec=spec, n_model=n_model, n_fsdp=n_fsdp,
                         shard_dims=tuple(shard_dims),
                         fsdp_dims=tuple(fsdp_dims),
                         local_offsets=tuple(local_offsets), a_local=a_off,
                         b_leaves=tuple(b_leaves), b_offsets=tuple(b_offsets),
                         b_size=b_off, b_chunk=b_chunk,
                         c_leaves=tuple(c_leaves), c_offsets=tuple(c_offsets),
                         c_size=c_off, c_chunk=c_chunk,
                         rep_leaves=tuple(rep_leaves),
                         rep_offsets=tuple(rep_offsets),
                         rep_size=r_off, rep_chunk=rep_chunk)


def resident_eshape(sspec: ShardPackSpec, i: int) -> Tuple[int, ...]:
    """Element shape of leaf ``i``'s per-shard resident slice (its model
    and fsdp dims divided where sharded)."""
    eshape = list(sspec.spec.shapes[i])
    if sspec.shard_dims[i] is not None:
        eshape[sspec.shard_dims[i]] //= sspec.n_model
    if sspec.fsdp_dims[i] is not None:
        eshape[sspec.fsdp_dims[i]] //= sspec.n_fsdp
    return tuple(eshape)


def _flat(leaf: Tensor, eshape: Tuple[int, ...], i: int) -> Tensor:
    """A resident leaf as ``lead + (n,)`` (a view where it can be; the
    caller casts while it copies)."""
    nb = leaf.dim() - len(eshape)
    if nb < 0 or tuple(leaf.shape[nb:]) != eshape:
        raise ValueError(f"leaf {i} shape {tuple(leaf.shape)} does not end "
                         f"with expected shard-local shape {eshape}")
    return leaf.reshape(tuple(leaf.shape[:nb]) + (-1,))


def _seg_flats(sspec: ShardPackSpec, leaves, idxs) -> List[Tensor]:
    return [_flat(leaves[i], resident_eshape(sspec, i), i) for i in idxs]


def _copy_seg_range(dst: Tensor, flats: Sequence[Tensor],
                    offsets: Sequence[int], lo: int, hi: int) -> None:
    """``dst[..., :hi-lo]`` ← positions ``[lo, hi)`` of the zero-padded
    segment that concatenates ``flats`` at ``offsets``, without forming
    the segment: each leaf's overlap is copied (cast to f32) once, and the
    padding tail is zeroed."""
    end = lo
    for f, o in zip(flats, offsets):
        n = f.shape[-1]
        s, e = max(o, lo), min(o + n, hi)
        if s < e:
            dst[..., s - lo:e - lo].copy_(f[..., s - o:e - o])
        end = max(end, min(o + n, hi))
    if end < hi:
        dst[..., end - lo:hi - lo].zero_()


def _seg_resident(sspec: ShardPackSpec, leaves, idxs, offsets,
                  pad_to: int) -> Optional[Tensor]:
    """Zero-padded f32 segment from RESIDENT leaf slices."""
    if not idxs:
        return None
    flats = _seg_flats(sspec, leaves, idxs)
    out = torch.empty(tuple(flats[0].shape[:-1]) + (pad_to,),
                      dtype=torch.float32, device=flats[0].device)
    _copy_seg_range(out, flats, offsets, 0, pad_to)
    return out


def _leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def rep_segment(sspec: ShardPackSpec, tree: PyTree) -> Optional[Tensor]:
    """The fully replicated (class-D) leaves as the zero-padded segment
    ``lead + (rep_pad,)`` (None when no leaf is replicated on the grid)."""
    return _seg_resident(sspec, _leaves(tree), sspec.rep_leaves,
                         sspec.rep_offsets, sspec.rep_pad)


def b_segment(sspec: ShardPackSpec, tree: PyTree) -> Optional[Tensor]:
    """One model shard's B segment from its RESIDENT class-B slices."""
    return _seg_resident(sspec, _leaves(tree), sspec.b_leaves,
                         sspec.b_offsets, sspec.b_pad)


def c_segment(sspec: ShardPackSpec, tree: PyTree) -> Optional[Tensor]:
    """One fsdp shard's C segment from its RESIDENT class-C slices."""
    return _seg_resident(sspec, _leaves(tree), sspec.c_leaves,
                         sspec.c_offsets, sspec.c_pad)


def _chunk_at(seg: Tensor, idx: int, chunk: int) -> Tensor:
    return seg[..., idx * chunk:(idx + 1) * chunk]


def rep_chunk_at(sspec: ShardPackSpec, seg: Tensor, shard_idx: int) -> Tensor:
    """Shard ``shard_idx``'s slice of the replicated segment."""
    return _chunk_at(seg, shard_idx, sspec.rep_chunk)


def split_idx(sspec: ShardPackSpec, shard_idx: int) -> Tuple[int, int]:
    """Flat shard index -> (model_idx, fsdp_idx), fsdp-major."""
    return shard_idx % sspec.n_model, shard_idx // sspec.n_model


def pack_shard_local(sspec: ShardPackSpec, tree: PyTree,
                     shard_idx: int) -> Tensor:
    """Pack ONE shard's resident data, ``lead + (d_local,)`` f32: every leaf
    arrives as the slice the grid makes resident (class A sliced on both
    dims, B on the model dim, C on the fsdp dim, D whole, of which the
    shard keeps its chunk).  Each leaf is cast and copied once into the
    buffer, with no padded segment formed on the side."""
    leaves = _leaves(tree)
    if len(leaves) != sspec.spec.n_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                         f"{sspec.spec.n_leaves}")
    jm, jf = split_idx(sspec, shard_idx)
    lead = tuple(leaves[0].shape[:leaves[0].dim()
                                 - len(resident_eshape(sspec, 0))])
    buf = torch.empty(lead + (sspec.d_local,), dtype=torch.float32,
                      device=leaves[0].device)
    for i, off in enumerate(sspec.local_offsets):
        if off is not None:
            f = _flat(leaves[i], resident_eshape(sspec, i), i)
            buf[..., off:off + f.shape[-1]].copy_(f)
    for idxs, offs, chunk, start, k in (
            (sspec.b_leaves, sspec.b_offsets, sspec.b_chunk, sspec.b_start,
             jf),
            (sspec.c_leaves, sspec.c_offsets, sspec.c_chunk, sspec.c_start,
             jm),
            (sspec.rep_leaves, sspec.rep_offsets, sspec.rep_chunk,
             sspec.sharded_local, shard_idx)):
        if idxs:
            _copy_seg_range(buf[..., start:start + chunk],
                            _seg_flats(sspec, leaves, idxs), offs,
                            k * chunk, (k + 1) * chunk)
    return buf


def unpack_shard_local(sspec: ShardPackSpec, buf: Tensor,
                       rep_seg: Optional[Tensor] = None,
                       cast: bool = False, *,
                       b_seg: Optional[Tensor] = None,
                       c_seg: Optional[Tensor] = None) -> PyTree:
    """One shard's ``lead + (d_local,)`` buffer -> its resident tree (views).

    Class-A leaves come straight from the buffer; class B/C/D leaves from
    the FULL ``b_seg``/``c_seg``/``rep_seg`` segments, which the caller
    rebuilds from the shards' chunks (``tree_ota._segs_psum``).  A segment
    may be omitted only when no leaf lives in it; on a grid where a
    segment is not split (``n_fsdp == 1`` for B, ``n_model == 1`` for C)
    the shard's own chunk is the segment and is taken from the buffer."""
    if buf.shape[-1] != sspec.d_local:
        raise ValueError(f"buffer last dim {buf.shape[-1]} != d_local "
                         f"{sspec.d_local}")
    if b_seg is None and sspec.b_leaves and sspec.n_fsdp == 1:
        b_seg = shard_b_chunk(sspec, buf)      # chunk == full segment in 1D
    if c_seg is None and sspec.c_leaves and sspec.n_model == 1:
        c_seg = shard_c_chunk(sspec, buf)
    for name, seg, idxs in (("rep_seg", rep_seg, sspec.rep_leaves),
                            ("b_seg", b_seg, sspec.b_leaves),
                            ("c_seg", c_seg, sspec.c_leaves)):
        if idxs and seg is None:
            raise ValueError(f"{name} required: tree has leaves in that "
                             "ownership class")
    out: List[Optional[Tensor]] = [None] * sspec.spec.n_leaves

    def take(seg, i, off, size):
        lead = tuple(seg.shape[:-1])
        out[i] = seg[..., off:off + size].reshape(lead
                                                  + resident_eshape(sspec, i))

    for i, off in enumerate(sspec.local_offsets):
        if off is not None:
            take(buf, i, off, sspec.spec.sizes[i] // sspec.n_shards)
    for i, off in zip(sspec.b_leaves, sspec.b_offsets):
        take(b_seg, i, off, sspec.spec.sizes[i] // sspec.n_model)
    for i, off in zip(sspec.c_leaves, sspec.c_offsets):
        take(c_seg, i, off, sspec.spec.sizes[i] // sspec.n_fsdp)
    for i, off in zip(sspec.rep_leaves, sspec.rep_offsets):
        take(rep_seg, i, off, sspec.spec.sizes[i])
    if cast:
        out = [p.to(sspec.spec.dtypes[i]) for i, p in enumerate(out)]
    return tree_unflatten(sspec.spec.treedef, out)


def shard_rep_chunk(sspec: ShardPackSpec, buf: Tensor) -> Optional[Tensor]:
    """The D-segment tail of one shard's local buffer (None when no leaf is
    fully replicated)."""
    if not sspec.rep_leaves:
        return None
    return buf[..., sspec.sharded_local:sspec.d_local]


def shard_b_chunk(sspec: ShardPackSpec, buf: Tensor) -> Optional[Tensor]:
    if not sspec.b_leaves:
        return None
    return buf[..., sspec.b_start:sspec.b_start + sspec.b_chunk]


def shard_c_chunk(sspec: ShardPackSpec, buf: Tensor) -> Optional[Tensor]:
    if not sspec.c_leaves:
        return None
    return buf[..., sspec.c_start:sspec.c_start + sspec.c_chunk]


def _scatter_chunk(chunk: Tensor, idx: int, width: int, pad: int) -> Tensor:
    seg = chunk.new_zeros(tuple(chunk.shape[:-1]) + (pad,))
    seg[..., idx * width:(idx + 1) * width].copy_(chunk)
    return seg


def scatter_rep_chunk(sspec: ShardPackSpec, chunk: Tensor,
                      shard_idx: int) -> Tensor:
    """Shard ``shard_idx``'s D chunk at its offset in a zeroed ``lead +
    (rep_pad,)`` segment: summed over ALL shard axes these rebuild the
    replicated segment."""
    return _scatter_chunk(chunk, shard_idx, sspec.rep_chunk, sspec.rep_pad)


def scatter_b_chunk(sspec: ShardPackSpec, chunk: Tensor,
                    fsdp_idx: int) -> Tensor:
    """Fsdp shard ``fsdp_idx``'s B chunk in a zeroed ``(b_pad,)`` segment:
    a sum over the fsdp axis rebuilds one model shard's B segment."""
    return _scatter_chunk(chunk, fsdp_idx, sspec.b_chunk, sspec.b_pad)


def scatter_c_chunk(sspec: ShardPackSpec, chunk: Tensor,
                    model_idx: int) -> Tensor:
    """Model shard ``model_idx``'s C chunk in a zeroed ``(c_pad,)``
    segment: a sum over the model axis rebuilds one fsdp shard's C
    segment."""
    return _scatter_chunk(chunk, model_idx, sspec.c_chunk, sspec.c_pad)


def shard_valid_mask(sspec: ShardPackSpec, shard_idx: int,
                     device="cpu") -> Tensor:
    """(d_local,) bool: True where this shard's position holds a real
    element, False on the zero-padding tails of the B/C/D segments, which
    must never re-enter the air."""
    jm, jf = split_idx(sspec, shard_idx)
    cols = torch.arange(sspec.d_local, device=device)
    valid = cols < sspec.a_local
    in_b = (cols >= sspec.b_start) & (cols < sspec.c_start)
    valid |= in_b & (jf * sspec.b_chunk + (cols - sspec.b_start)
                     < sspec.b_size)
    in_c = (cols >= sspec.c_start) & (cols < sspec.sharded_local)
    valid |= in_c & (jm * sspec.c_chunk + (cols - sspec.c_start)
                     < sspec.c_size)
    in_d = cols >= sspec.sharded_local
    valid |= in_d & (shard_idx * sspec.rep_chunk
                     + (cols - sspec.sharded_local) < sspec.rep_size)
    return valid


# -- canonical-index maps (the packing <-> sketch-codec contract) -----------

_U32 = (1 << 32) - 1


def _resident_flat_index(sspec: ShardPackSpec, i: int, jm: int,
                         jf: int, device="cpu") -> Tensor:
    """Canonical PackSpec index of every element of leaf ``i``'s resident
    slice on shard (jm, jf), as int64 wrapped mod 2³² (the JAX package's
    uint32 indices, which wrap at >4G-parameter scale)."""
    eshape = sspec.spec.shapes[i]
    lshape = resident_eshape(sspec, i)
    md, fd = sspec.shard_dims[i], sspec.fsdp_dims[i]
    idx = torch.zeros(lshape, dtype=torch.int64, device=device)
    stride = 1
    for axis in range(len(lshape) - 1, -1, -1):
        view = [1] * len(lshape)
        view[axis] = lshape[axis]
        ax = torch.arange(lshape[axis], dtype=torch.int64,
                          device=device).reshape(view)
        if axis == md:
            ax = ax + lshape[axis] * jm
        if axis == fd:
            ax = ax + lshape[axis] * jf
        idx = idx + ax * stride
        stride *= eshape[axis]
    return ((idx + sspec.spec.offsets[i]) & _U32).reshape(-1)


def _seg_perm(sspec: ShardPackSpec, idxs, jm: int, jf: int,
              pad_to: int, device="cpu") -> Tensor:
    seg = torch.cat([_resident_flat_index(sspec, i, jm, jf, device)
                     for i in idxs])
    return torch.nn.functional.pad(seg, (0, pad_to - seg.shape[0]))


def b_segment_perm(sspec: ShardPackSpec, model_idx: int,
                   device="cpu") -> Optional[Tensor]:
    """(b_pad,) canonical indices of model shard ``model_idx``'s B segment
    (0 on padding: pair with ``arange(b_pad) < b_size``)."""
    if not sspec.b_leaves:
        return None
    return _seg_perm(sspec, sspec.b_leaves, model_idx, 0, sspec.b_pad,
                     device)


def c_segment_perm(sspec: ShardPackSpec, fsdp_idx: int,
                   device="cpu") -> Optional[Tensor]:
    """(c_pad,) canonical indices of fsdp shard ``fsdp_idx``'s C segment."""
    if not sspec.c_leaves:
        return None
    return _seg_perm(sspec, sspec.c_leaves, 0, fsdp_idx, sspec.c_pad, device)


def rep_segment_perm(sspec: ShardPackSpec,
                     device="cpu") -> Optional[Tensor]:
    """(rep_pad,) canonical indices of the global D segment."""
    if not sspec.rep_leaves:
        return None
    return _seg_perm(sspec, sspec.rep_leaves, 0, 0, sspec.rep_pad, device)


def shard_perm_local(sspec: ShardPackSpec, shard_idx: int,
                     device="cpu") -> Tensor:
    """(d_local,) canonical :class:`PackSpec` index of every position of
    ONE shard's local buffer (int64 wrapped mod 2³²), built on ``device``;
    padding carries 0, so pair it with :func:`shard_valid_mask`."""
    jm, jf = split_idx(sspec, shard_idx)
    parts = []
    for i, off in enumerate(sspec.local_offsets):
        if off is not None:
            parts.append(_resident_flat_index(sspec, i, jm, jf, device))
    if sspec.b_leaves:
        parts.append(_chunk_at(b_segment_perm(sspec, jm, device), jf,
                               sspec.b_chunk))
    if sspec.c_leaves:
        parts.append(_chunk_at(c_segment_perm(sspec, jf, device), jm,
                               sspec.c_chunk))
    if sspec.rep_leaves:
        parts.append(_chunk_at(rep_segment_perm(sspec, device), shard_idx,
                               sspec.rep_chunk))
    return torch.cat(parts)


def shard_perm(sspec: ShardPackSpec):
    """(d_pad,) int64 numpy array: canonical :class:`PackSpec` index of
    every shard-packed position (-1 on padding).  Host-side, for tests and
    layout checks."""
    import numpy as np

    return np.concatenate([
        np.where(shard_valid_mask(sspec, j).numpy(),
                 shard_perm_local(sspec, j).numpy(), -1)
        for j in range(sspec.n_shards)]).astype(np.int64)


def slice_block(sspec: ShardPackSpec, leaf: Tensor, i: int, jm: int,
                jf: int) -> Tensor:
    """A global leaf (``lead + shapes[i]``) -> its (jm, jf) resident block,
    a view."""
    nb = leaf.dim() - len(sspec.spec.shapes[i])
    md, fd = sspec.shard_dims[i], sspec.fsdp_dims[i]
    if md is not None:
        c = sspec.spec.shapes[i][md] // sspec.n_model
        leaf = leaf.narrow(nb + md, jm * c, c)
    if fd is not None:
        c = sspec.spec.shapes[i][fd] // sspec.n_fsdp
        leaf = leaf.narrow(nb + fd, jf * c, c)
    return leaf


def shard_tree(sspec: ShardPackSpec, tree: PyTree, shard_idx: int) -> PyTree:
    """A GLOBAL tree -> the tree of shard ``shard_idx``'s resident blocks
    (views; replicated leaves whole)."""
    jm, jf = split_idx(sspec, shard_idx)
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        (Complex(slice_block(sspec, l.re, i, jm, jf),
                 slice_block(sspec, l.im, i, jm, jf))
         if isinstance(l, Complex) else slice_block(sspec, l, i, jm, jf))
        for i, l in enumerate(leaves)])


def pack_shard_global(sspec: ShardPackSpec, tree: PyTree) -> Tensor:
    """GLOBAL tree -> the full ``lead + (d_pad,)`` shard-packed buffer: the
    concatenation of every shard's local pack, fsdp-major (state init and
    tests; a round packs only its own shard)."""
    return torch.cat([pack_shard_local(sspec, shard_tree(sspec, tree, j), j)
                      for j in range(sspec.n_shards)], dim=-1)


def unpack_shard_global(sspec: ShardPackSpec, buf: Tensor,
                        cast: bool = True) -> PyTree:
    """Full ``lead + (d_pad,)`` shard-packed buffer -> GLOBAL tree (the
    inverse of :func:`pack_shard_global`)."""
    if buf.shape[-1] != sspec.d_pad:
        raise ValueError(f"buffer last dim {buf.shape[-1]} != d_pad "
                         f"{sspec.d_pad}")
    dl = sspec.d_local
    locs = [buf[..., j * dl:(j + 1) * dl] for j in range(sspec.n_shards)]

    def seg(chunks):
        return torch.cat(chunks, dim=-1) if len(chunks) > 1 else chunks[0]

    rep = (seg([shard_rep_chunk(sspec, b) for b in locs])
           if sspec.rep_leaves else None)
    pieces = []                  # per shard: its resident tree's leaves
    for j in range(sspec.n_shards):
        jm, jf = split_idx(sspec, j)
        b = (seg([shard_b_chunk(sspec, locs[f * sspec.n_model + jm])
                  for f in range(sspec.n_fsdp)]) if sspec.b_leaves else None)
        c = (seg([shard_c_chunk(sspec, locs[jf * sspec.n_model + m])
                  for m in range(sspec.n_model)]) if sspec.c_leaves else None)
        pieces.append(tree_flatten(unpack_shard_local(
            sspec, locs[j], rep, b_seg=b, c_seg=c))[0])
    lead = len(buf.shape) - 1
    out = []
    for i in range(sspec.spec.n_leaves):
        md, fd = sspec.shard_dims[i], sspec.fsdp_dims[i]
        rows = []
        for jf in range(sspec.n_fsdp if fd is not None else 1):
            cols = [pieces[jf * sspec.n_model + jm][i]
                    for jm in range(sspec.n_model if md is not None else 1)]
            rows.append(torch.cat(cols, dim=lead + md) if len(cols) > 1
                        else cols[0])
        leaf = (torch.cat(rows, dim=lead + fd) if len(rows) > 1 else rows[0])
        out.append(leaf.to(sspec.spec.dtypes[i]) if cast else leaf)
    return tree_unflatten(sspec.spec.treedef, out)


def pack_shard_global_cplx(sspec: ShardPackSpec, tree: PyTree) -> Complex:
    """Complex-leaf tree -> Complex of global shard-packed planes."""
    return Complex(pack_shard_global(sspec, tree_map(lambda c: c.re, tree)),
                   pack_shard_global(sspec, tree_map(lambda c: c.im, tree)))


def unpack_shard_global_cplx(sspec: ShardPackSpec, buf: Complex) -> PyTree:
    """Complex global shard-packed planes -> tree of Complex leaves (f32)."""
    re = tree_flatten(unpack_shard_global(sspec, buf.re, cast=False))[0]
    im = tree_flatten(unpack_shard_global(sspec, buf.im, cast=False))[0]
    return tree_unflatten(sspec.spec.treedef,
                          [Complex(r, i) for r, i in zip(re, im)])
