"""The partitioned products: on a mesh whose ``model`` axis splits a
layer, each rank computes only its own part of each product, in the
layer's parallel form, and no rank gathers the layer.

The JAX package binds the logical axes ``heads``, ``kv_heads``, ``ff`` and
``vocab`` to ``model`` (``launch.shardings.rules_for``: where the count
divides the axis) and annotates the activations on them; XLA then
partitions each product.  The port does it by hand, with the parameter
layout ``launch.shardings`` already gives every rank (its column or row
block, ``core.packing.ShardPackSpec``):

* attention: rank r of m runs query heads ``[r·H/m, (r+1)·H/m)`` on its
  ``wq`` columns and KV heads ``[r·KV/m, (r+1)·KV/m)`` on its ``wk``/``wv``
  columns (under ``head = kv·g + i`` these are exactly the KV heads its
  query heads read).  Where ``kv_heads`` is unbound, ``wk``/``wv`` stay
  whole on every rank (gathered, or replicated) and each rank projects the
  KV heads its query heads read.  ``wo`` is row-split: the ranks' partial
  outputs are summed in f32 (:func:`~repro_torch.launch.mesh.reduce_from`)
  and rounded once, and ``wo``'s bias, if any, is added once after the
  sum;
* the MLP: ``gate``/``up``/``fc_in`` column-split, ``down``/``fc_out``
  row-split (``fc_out``'s bias after the sum); the MoE's shared expert
  alike, on its own hidden width;
* the MoE's routed experts (``models/moe._dispatch_compute``): every rank
  routes, sorts and drops the whole (token, k) set alike, and rank r
  runs experts ``[r·E/m, (r+1)·E/m)`` on their capacity buffers; the
  ranks' partial combines are summed;
* the SSM (``models/ssm.py``, where ``inner`` binds: ``d_inner``
  divides the axis): rank r runs channels ``[r·c, (r+1)·c)``, c =
  d_inner/m.  ``in_proj``'s stored column block is chunks 2r and 2r + 1
  of the 2m chunks of ``[x | z]``; one all-to-all
  (:meth:`Partition.inner_xz`) leaves the rank its x and z chunks.  The
  conv, ``A_log``, ``D`` and ``dt_proj``'s columns (and bias) are read on
  the rank's channels through ``copy_to`` (:meth:`Partition.channels`);
  ``x_proj`` runs whole on x's channels gathered
  (:meth:`Partition.gather_inner`), one device's contraction; the normed
  (dt, B, C), whole on every rank but used on its channels alone, pass a
  ``copy_to``; B12 scans the rank's channels; ``out_proj`` is row-split.
  The trainer and the prefill gather ``x_proj``, ``dt_proj`` and
  ``dt_proj``'s bias (split on its layer dim); decode keeps ``x_proj``'s
  columns (the token's channels gathered, its columns projected and
  gathered) and ``dt_proj``'s rows (the partials reduce-scattered to the
  rank's channels, ``scatter_inner``), and gathers the bias alone;
* the hybrid's RG-LRU block (``models/hybrid.py``, where ``lru`` binds:
  ``lru_width`` divides the axis): rank r runs channels ``[r·c, (r+1)·c)``,
  c = lru_width/m.  ``w_gelu``'s and ``w_rec``'s column blocks give the
  rank's channels of the gelu branch and of the recurrence's input; the
  conv and Λ (``conv_w``, ``conv_b``, ``lam``, replicated) are read on
  them (:meth:`Partition.channels`); the conv's output is gathered once
  (:meth:`Partition.gather_inner` with ``partial``: its backward
  reduce-scatters the ranks' partial gradients) for the column blocks of
  ``gate_a`` and ``gate_x``, one device's contraction over every channel;
  B12 scans the rank's channels; ``w_out`` is row-split.  The gates'
  biases are laid out two ways by one rule (``launch.shardings``: a leaf
  of two or more dims splits its last): a stacked super-block's (L, dw)
  is the rank's block, the tail's (dw,) is replicated and read on the
  rank's channels.  The local attention and the MLP take the dense
  family's plan above (the attention whole, its weights gathered, where
  the heads do not split);
* the audio enc-dec (``models/encdec.py``): the encoder's bidirectional
  attention, the decoder's self- and cross-attention and every MLP take
  the plan above (``self_attn``/``cross_attn`` resolve as ``attn``); the
  cross-attention's K and V are each decoder layer's column block of the
  one encoder memory, so the memory is read through ``copy_to`` once
  before the decoder (its gradient the ranks' partials summed);
* the embedding: a vocab-parallel lookup (each rank its rows
  ``[r·V/m, (r+1)·V/m)``, zeros elsewhere, summed: one nonzero addend a
  row, so exact), and the unembedding on the rank's vocab rows, which
  leaves the logits split over the vocab for the vocab-parallel
  cross-entropy (``models/registry._xent``).

A column-split product reads its input through
:func:`~repro_torch.launch.mesh.copy_to`, whose backward sums the ranks'
partial input gradients, so everything outside the products (norms,
residual stream, RoPE) is computed and differentiated alike on every
rank.  A leaf a rank holds whole but uses for its own part only (the K/V
projection and its bias where the KV heads do not split) is read through
``copy_to`` as well, so its gradient is the whole product's on every
rank.  The column biases of the split products need no such slice: as
stacked (L, n) leaves their last dim splits over ``model`` like their
weight's.

Serving takes the same plan (``serve/serving.py``): the prefill is the
forward above, its last logits gathered whole (:meth:`Partition
.gather_vocab`); decode (``layers.attention_decode``,
``moe.mla_decode``) keeps its cache as the block
``launch.shardings.cache_pspec`` gives the rank (:func:`partition_for`'s
``cache``, read from the cache's attention leaf):

* ``"heads"`` (the KV heads divide ``model``, exactly where ``kv_heads``
  binds): the rank's KV heads, which its query heads read;
* ``"seq"`` (they do not): a slice of the sequence over ``model``, or over
  the data axes and ``model`` where the batch does not split.  Each rank
  projects every KV head (``wk``/``wv`` whole), the owner of the slot
  writes it, the query heads are gathered, each rank scores every head on
  its slots and the ranks join their partial softmaxes
  (:meth:`Partition.combine_attention`);
* ``"batch"``: the batch rows only (no layout splits the sequence).

The enc-dec's caches (``self_k``/``self_v`` over the decoded positions,
``cross_k``/``cross_v`` over the encoder's frames) lie on their KV heads
together where the heads split; where they do not, each by its own spec:
the self cache on its slots (:attr:`Partition.cache`), the cross cache on
its frames where they divide the axes (:attr:`Partition.cross_cache`
``"seq"``, over :attr:`Partition.cross_seq_axes`), else whole
(``"batch"``).

The SSM's state ``ssm`` (L, B, di, n) and conv window ``conv`` (L, B,
K − 1, di) lie on their channels (``"inner"``).  The hybrid's cache has
both kinds of leaf: its RG-LRU state ``lru`` (L?, B, dw) and conv window
``conv`` (L?, B, K − 1, dw) on their channels wherever the plan splits
them (:attr:`Partition.lru`), and its attention layers' rotating ``k``/``v``
(L, B, window, KV, hd) as the dense family's, by the layout of ``k``
(:attr:`Partition.cache`: the window's slots over ``model`` where the one
KV head does not split).  MLA's latent cache
(``c_kv``/``k_rope``) lies on the sequence wherever it splits, whatever
the KV heads do: each rank computes the token's latent
entries, the owner of the slot writes them, its heads' absorbed queries
are gathered, and the partial softmaxes are joined as above.

The greedy token is the first index of the row's maximum over the
vocab-parallel logits (:meth:`Partition.argmax_vocab`).

Where ``kv_heads`` is unbound but ``KV·hd`` divides ``model``, serving's
plan (``partition_for(..., serve=True)``: :attr:`Partition.kv_cols`) keeps
``wk``/``wv`` as the rank's column block, as ``launch.shardings`` lays
them out: a rank projects its columns and the ranks' (…, KV·hd/m) results
are gathered (:meth:`Partition.gather_cols`, ``gather_kv`` in
``Mesh.stats``).  The trainer reads them whole through ``copy_to``
instead: a gather of the projection would need a reduce-scatter
backward.  Decode's plan (``partition_for(...,
decode=True)``: :attr:`Partition.proj_cols`) does the same with the
router, ``wq_a`` and ``wkv_a``, column-split by the layout: a rank
projects the token on its columns and the (B, 1, ·) results of a layer's
attention (``wq_a`` and ``wkv_a``), or of its router, are gathered in one
all-gather (:func:`gather_proj`); every rank then normalises, rotates and
routes the whole result alike.  The prefill reads those three whole
(gathered): at S tokens their outputs outweigh the weights.

The trainer's plan (:func:`partition_for`) covers :data:`FAMILIES` (dense,
vlm, moe, ssm, hybrid and audio; the ssm only where ``inner`` binds, the
hybrid only where ``lru`` does), and serving's :data:`SERVE_FAMILIES` the
same six; where the plan is None the layers are gathered whole
(``models/gather``).  A model-sharded leaf whose product is not
partitioned
(pixtral's ``projector`` and the MTP's ``mtp_proj``, whose outputs are
the residual stream; ``fc_out``'s bias, split on its layer dim;
``wk``/``wv`` where ``kv_heads`` is unbound; the router, ``wq_a`` and
``wkv_a`` outside decode; the experts where ``n_experts`` does not divide
``model``, and the MTP block's, which the layout splits on their hidden
dim) is gathered as before (:func:`gathered_model_leaf`).  Serving reads
no MTP leaf (:data:`MTP_KEYS`) and gathers none.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch.mesh import copy_to, reduce_from

Tensor = torch.Tensor

#: the families whose training products partition over ``model``
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
#: the families whose serving products partition
SERVE_FAMILIES = FAMILIES
#: the small column-split projections serving's decode keeps as the
#: rank's columns, their (B, 1, ·) outputs gathered
#: (:attr:`Partition.proj_cols`): the router, MLA's ``wq_a`` and ``wkv_a``
_PROJ_LEAVES = {("mlp", "router"), ("attn", "wq_a"), ("attn", "wkv_a")}
#: the MTP head's leaves, which serving never reads
MTP_KEYS = ("mtp_block", "mtp_proj", "mtp_norm")
#: the stacked layer keys whose entries partition, and the unstacked
#: blocks that do
_STACKS = ("layers", "dense_layers", "moe_layers", "super", "enc_layers",
           "dec_layers")
_BLOCKS = ("mtp_block",)
#: the hybrid's layers: the stacked super-blocks and the ``tail`` list, a
#: leaf at (its key, the block ``b{i}`` or ``#{j}``, ``temporal`` or
#: ``mlp_blk``, …)
_HYBRID = ("super", "tail")
#: each partitioned dense leaf: (its layer key, its param name) -> (the
#: Partition field that must be set, its split: "col" | "row")
_LEAVES = {
    ("attn", "wq"): ("heads", "col"), ("attn", "wo"): ("heads", "row"),
    ("attn", "wq_b"): ("heads", "col"),
    ("attn", "wk"): ("kv", "col"), ("attn", "wv"): ("kv", "col"),
    ("mlp", "gate"): ("ff", "col"), ("mlp", "up"): ("ff", "col"),
    ("mlp", "down"): ("ff", "row"), ("mlp", "fc_in"): ("ff", "col"),
    ("mlp", "fc_out"): ("ff", "row"),
    ("shared", "gate"): ("shared_ff", "col"),
    ("shared", "up"): ("shared_ff", "col"),
    ("shared", "down"): ("shared_ff", "row"),
}
#: the enc-dec decoder's attention blocks, whose leaves split as
#: ``attn``'s
_ATTN_KEYS = ("self_attn", "cross_attn")
#: the routed experts' leaves (E, d, f) / (E, f, d), split on E
_EXPERT_LEAVES = ("gate", "up", "down")
#: MLA's per-head leaves (H, c, ·), split on H
_HEAD_LEAVES = ("wk_b", "wv_b")
#: the SSM's leaves under a partition of its inner channels: (its param
#: name, and "w" for a dense's weight) -> its split; "narrow": held whole
#: (replicated), each rank reading its channels
_INNER_LEAVES = {
    ("in_proj", "w"): "col", ("out_proj", "w"): "row",
    ("conv_w",): "narrow", ("conv_b",): "narrow", ("A_log",): "narrow",
    ("D",): "narrow",
}
#: the SSM's leaves decode keeps as the rank's block where the layout
#: splits them (:attr:`Partition.proj_cols`): ``x_proj``'s columns and
#: ``dt_proj``'s rows
_INNER_DECODE = {("x_proj", "w"): "col", ("dt_proj", "w"): "row"}
#: the RG-LRU block's leaves under a partition of its channels, as
#: :data:`_INNER_LEAVES`; "bias": the gates' biases, "col" in a stacked
#: super-block (L, dw) and "narrow" in the tail (dw,), as the layout
#: splits a leaf of two or more dims on its last
_LRU_LEAVES = {
    ("w_gelu", "w"): "col", ("w_rec", "w"): "col", ("gate_a", "w"): "col",
    ("gate_x", "w"): "col", ("w_out", "w"): "row", ("conv_w",): "narrow",
    ("conv_b",): "narrow", ("lam",): "narrow", ("gate_a", "b"): "bias",
    ("gate_x", "b"): "bias",
}


class Partition(NamedTuple):
    """Which products a rank computes its part of, over ``axis``, and how
    serving's decode cache lies on the mesh."""

    mesh: Any
    axis: str           # the mesh axis the products split over
    n: int              # its size
    index: int          # this rank's coordinate on it
    heads: bool         # attention's query heads (and ``wo``'s rows)
    kv: bool            # the KV heads (else ``wk``/``wv`` are whole)
    ff: bool            # the MLP's hidden columns
    vocab: bool         # the embedding's and the logits' vocab rows
    #: the decode cache's split beside the batch: "heads" | "seq" |
    #: "inner" (the SSM's channels) | "batch"; the enc-dec's self cache
    cache: str = "batch"
    #: the mesh axes the cache's sequence splits over ("seq")
    seq_axes: Tuple[str, ...] = ()
    #: the enc-dec's cross cache: "heads" (with the self cache) | "seq"
    #: (its frames over :attr:`cross_seq_axes`) | "batch" (whole)
    cross_cache: str = "batch"
    cross_seq_axes: Tuple[str, ...] = ()
    #: the MoE's routed experts (``n_experts`` divides the axis)
    expert: bool = False
    #: the MoE shared expert's hidden columns (``moe_d_ff ·
    #: n_shared_experts`` divides the axis)
    shared_ff: bool = False
    #: serving: ``wk``/``wv`` held as the rank's column block where the KV
    #: heads do not split, their projections gathered
    #: (:meth:`gather_cols`)
    kv_cols: bool = False
    #: serving's decode: the names of :data:`_PROJ_LEAVES` (``router``,
    #: ``wq_a``, ``wkv_a``) held as the rank's column block, their
    #: one-token projections gathered (:meth:`gather_cols`); the SSM's
    #: ``x_proj`` (its columns) and ``dt_proj`` (its rows)
    proj_cols: Tuple[str, ...] = ()
    #: the SSM's inner channels (``d_inner`` divides the axis)
    inner: bool = False
    #: the hybrid's RG-LRU channels (``lru_width`` divides the axis); its
    #: cache's ``lru`` and ``conv`` on them beside :attr:`cache`, which is
    #: its attention layers'
    lru: bool = False

    @property
    def seq_index(self) -> int:
        """This rank's slice of the cache's sequence."""
        return self.mesh.axis_index(self.seq_axes)

    @property
    def seq_n(self) -> int:
        """The slices of the cache's sequence."""
        return self.mesh.axis_size(self.seq_axes)

    @property
    def cross(self) -> "Partition":
        """This plan with the enc-dec's cross cache as its cache: its
        layout and sequence axes in :attr:`cache` and :attr:`seq_axes`."""
        return self._replace(cache=self.cross_cache,
                             seq_axes=self.cross_seq_axes)

    # -- collectives ---------------------------------------------------------

    def copy_to(self, x: Tensor) -> Tensor:
        return copy_to(x, self.mesh, self.axis)

    def reduce_from(self, x: Tensor) -> Tensor:
        return reduce_from(x, self.mesh, self.axis)

    def argmax_vocab(self, local: Tensor) -> Tensor:
        """The greedy token (..., ) int64 of vocab-parallel logits (...,
        V/n): the first index of the row's maximum over the whole vocab, as
        ``torch.argmax`` of the whole row (a tie across two ranks' rows
        takes the lower index).  The max of the ranks' maxima (exact), then
        the min of the global index of each rank's first hit."""
        v0 = self.index * local.shape[-1]
        lf = local.float()
        m = lf.amax(dim=-1)
        top = self.mesh.pmax(m, self.axis, op="vocab_max")
        first = torch.argmax(lf, dim=-1) + v0
        none = torch.full_like(first, v0 + self.n * local.shape[-1])
        cand = torch.where(m == top, first, none)
        return self.mesh.pmin(cand, self.axis, op="vocab_min")

    def gather_vocab(self, local: Tensor) -> Tensor:
        """Vocab-parallel logits (..., V/n) whole, (..., V)."""
        return self.mesh.all_gather(local, self.axis, -1, op="gather_vocab")

    def gather_cols(self, *xs: Tensor, op: str = "gather_proj"
                    ) -> Tuple[Tensor, ...]:
        """The ranks' column blocks (..., n_i/n) of several projections
        of one dtype whole, (..., n_i) each, in one all-gather (named
        ``op`` in ``Mesh.stats``): the blocks concatenated, gathered over
        the axis rank after rank, and each projection's columns taken back
        in rank order."""
        widths = [x.shape[-1] for x in xs]
        y = self.mesh.all_gather(torch.cat(xs, -1), self.axis, -1, op=op)
        y = y.reshape(y.shape[:-1] + (self.n, sum(widths)))
        return tuple(p.reshape(p.shape[:-2] + (-1,))
                     for p in torch.split(y, widths, dim=-1))

    def gather_heads(self, q: Tensor) -> Tensor:
        """The ranks' query heads (..., H/n · hd) concatenated, (..., H ·
        hd), in head order."""
        return self.mesh.all_gather(q, self.axis, -1, op="gather_heads")

    def combine_attention(self, m: Tensor, l: Tensor, o: Tensor) -> Tensor:
        """The softmax of a sequence split over :attr:`seq_axes`, from each
        rank's partial over its slots: ``m`` the max score, ``l`` the sum
        of ``exp(s − m)`` (…, 1), ``o`` the sum of ``exp(s − m) · v`` (…,
        hd), all f32.  ``M = pmax(m)``, then
        ``Σ o·exp(m − M) / Σ l·exp(m − M)`` (one psum of both).  A rank
        whose slots are all masked (``m = −inf``; its ``l`` and ``o`` 0)
        weighs 0 through a ``where``, so no NaN of ``−inf − (−inf)`` enters
        the sum."""
        axes = self.seq_axes
        top = self.mesh.pmax(m, axes, op="softmax_max")
        live = torch.isfinite(m)
        w = torch.where(live, torch.exp(torch.where(live, m - top, 0.0)),
                        0.0)
        lo = torch.cat([o * w, l * w], -1)
        lo = self.mesh.psum(lo, axes, inplace=True, op="softmax_sum")
        return lo[..., :-1] / lo[..., -1:]

    # -- products ------------------------------------------------------------

    def dense_cols(self, p: dict, x: Tensor, n_full: int,
                   what: str = "column") -> Tensor:
        """A column-split dense on ``x`` (already read through
        :meth:`copy_to`): this rank's ``n_full / n`` output columns.  Its
        bias, a stacked (L, n_full) leaf, is split on its columns by the
        same layout rule as the weight, so the rank holds its block of
        both."""
        from repro_torch.models.layers import dense

        nl = n_full // self.n
        for k, t in p.items():
            if t.shape[-1] != nl:
                raise ValueError(f"{what}/{k}: the plan partitions it but "
                                 f"the rank holds {t.shape[-1]} of "
                                 f"{n_full} columns")
        return dense(p, x)

    def dense_slice(self, p: dict, x: Tensor, c0: int, c1: int) -> Tensor:
        """Columns ``[c0, c1)`` of a dense the rank holds whole (read
        through :meth:`copy_to`, so its gradient sums the ranks')."""
        from repro_torch.models.layers import _bcast, dense

        w = self.copy_to(p["w"]).narrow(-1, c0, c1 - c0)
        y = dense({"w": w}, x)
        if "b" in p:
            b = self.copy_to(p["b"]).narrow(-1, c0, c1 - c0)
            y = y + _bcast(b, y, 1)
        return y

    def channels(self, t: Tensor, dim: int = -1) -> Tensor:
        """The rank's ``1/n`` of dim ``dim`` of a leaf it holds whole (the
        SSM's ``conv_w``, ``A_log``, ``D``, the hybrid's conv and Λ, a
        bias): read through :meth:`copy_to`, so its gradient is the whole
        leaf's on every rank."""
        c = t.shape[dim] // self.n
        return self.copy_to(t).narrow(dim, self.index * c, c)

    def gather_inner(self, x: Tensor, partial: bool = False) -> Tensor:
        """An activation on the ranks' channels (…, c/n) whole (…, c), in
        channel order (``gather_inner`` in ``Mesh.stats``).  For a product
        every rank then computes whole and alike (the SSM's ``x_proj``)
        the backward keeps the rank's channels of the gradient, which
        every rank holds whole; with ``partial`` (each rank computes its
        column block of the products on it: the hybrid's gates) the ranks'
        partial gradients are summed and each keeps its channels, one
        reduce-scatter."""
        from repro_torch.models.gather import _Gather

        return _Gather.apply(x, self.mesh, self.axis, x.dim() - 1, partial,
                             partial, "gather_inner")

    def inner_xz(self, xz: Tensor) -> Tuple[Tensor, Tensor]:
        """The SSM's x and z on the rank's channels, (…, di/n) each, from
        its block of ``in_proj``'s output (…, 2·di/n): columns ``[r·2c,
        (r+1)·2c)`` of ``[x | z]`` with c = di/n, that is, chunks 2r and
        2r + 1 of the 2n chunks of width c, where rank r needs chunk r
        (its x) and chunk n + r (its z).  One all-to-all over the axis
        sends each chunk to its rank (:func:`~repro_torch.launch.mesh
        .all_to_all`: the chunks on a leading dim, each rank sending and
        receiving two; its backward is the inverse exchange)."""
        from repro_torch.launch.mesh import all_to_all

        flip, send, recv = xz_routes(self.n, self.index)
        chunks = xz.unflatten(-1, (2, xz.shape[-1] // 2)).movedim(-2, 0)
        if flip:
            chunks = chunks.flip(0)
        y = all_to_all(chunks.contiguous(), self.mesh, self.axis, send,
                       recv)
        return y[0], y[1]

    def dense_rows(self, p: dict, x: Tensor, n_full: int,
                   what: str = "row") -> Tensor:
        """A row-split dense on this rank's ``n_full / n`` input columns:
        the partial products computed and summed over the axis in f32 (at
        least), rounded once to ``x``'s dtype, as one device's product
        accumulates in f32 and rounds once; then the bias (whole on every
        rank) added once."""
        from repro_torch.models.layers import _bcast, dense

        w = p["w"]
        if w.shape[-2] != n_full // self.n:
            raise ValueError(f"{what}: the plan partitions it but the rank "
                             f"holds {w.shape[-2]} of {n_full} rows")
        acc = torch.promote_types(x.dtype, torch.float32)
        y = self.reduce_from(dense({"w": w.to(acc)}, x.to(acc))).to(x.dtype)
        if "b" in p:
            y = y + _bcast(p["b"], y, 1)
        return y

    def vocab_rows(self, table: Tensor, vocab: int) -> Tuple[int, int]:
        """This rank's first vocab row and row count."""
        vl = vocab // self.n
        if table.shape[-2] != vl:
            raise ValueError(f"embedding: the plan partitions the vocab but "
                             f"the rank holds {table.shape[-2]} of {vocab} "
                             f"rows")
        return self.index * vl, vl


def xz_routes(n: int, r: int) -> Tuple[bool, Tuple[int, ...],
                                        Tuple[int, ...]]:
    """Rank r's routes of :meth:`Partition.inner_xz` on an axis of n:
    whether its chunks 2r and 2r + 1 go out in reverse (each block goes
    in the order of its destination rank), the chunks it sends each rank
    (chunk k is rank k mod n's: x's chunk k, or z's chunk k − n) and the
    chunks it receives from each (chunk r from rank r // 2, before chunk
    n + r from rank (n + r) // 2)."""
    dests = ((2 * r) % n, (2 * r + 1) % n)
    send = tuple(int(j in dests) for j in range(n))
    recv = tuple(int(j in (r // 2, (n + r) // 2)) for j in range(n))
    return dests[0] > dests[1], send, recv


def partition_for(cfg, mesh, *, multi_pod: bool = False,
                  cache: Optional[Tuple[int, ...]] = None,
                  cache_leaf: str = "k", serve: bool = False,
                  decode: bool = False,
                  cross: Optional[Tuple[int, ...]] = None
                  ) -> Optional[Partition]:
    """The trainer's plan on ``mesh``: which products split over
    ``model`` (a logical axis partitions where
    ``launch.shardings.rules_for`` binds it to ``model``, as the reference
    decides); None where the axis has one rank or the family keeps the
    gathered forward.  With ``serve`` (or ``decode``, or ``cache``),
    serving's plan: the families of :data:`SERVE_FAMILIES`, and
    ``wk``/``wv`` kept as the rank's columns where the KV heads do not
    split but ``KV·hd`` does (:attr:`Partition.kv_cols`).  With ``decode``
    (or ``cache``), decode's: the router, ``wq_a`` and ``wkv_a`` kept as
    the rank's columns where their widths split
    (:attr:`Partition.proj_cols`).  With ``cache``, the global shape of
    the decode cache's attention leaf ``cache_leaf``, the cache's layout
    read from ``launch.shardings.cache_pspec``: for a K leaf (L, B, T,
    KV, hd) the KV heads over ``model`` where they divide it (which is
    where ``rules_for`` binds ``kv_heads``), else the sequence, else the
    batch alone; for MLA's latent ``c_kv`` (L, B, T, c) the sequence
    where it splits, else the batch, whatever the KV heads do.  The
    hybrid's plan is None where ``lru`` is unbound (the gathered forward);
    its ``cache`` is its super-blocks' ``k`` leaf, laid out as above, and
    their ``lru`` leaf beside it (L, B, dw) must lie on its channels.  The
    enc-dec's ``cache`` is its ``self_k`` leaf, laid out as a K leaf, and
    ``cross`` the global shape of its ``cross_k`` leaf (L, B, T_frames,
    KV, hd): on the KV heads with the self cache, else by its own spec,
    on its frames (:attr:`Partition.cross_cache`) or whole."""
    from repro_torch.launch.shardings import (_entry_axes, cache_pspec,
                                              rules_for)

    axis = "model"
    n = mesh.shape.get(axis, 1)
    decode = decode or cache is not None
    serve = serve or decode
    if n == 1 or cfg.family not in (SERVE_FAMILIES if serve else FAMILIES):
        return None
    rules = rules_for(cfg, mesh, multi_pod=multi_pod)

    def bound(name: str) -> bool:
        r = rules.get(name)
        return r == axis or (isinstance(r, tuple) and axis in r)

    def fits(k: int) -> bool:
        return k >= n and k % n == 0

    part = Partition(mesh, axis, n, mesh.axis_index(axis), bound("heads"),
                     bound("kv_heads"), bound("ff"), bound("vocab"),
                     expert=bool(cfg.n_experts) and bound("expert"),
                     shared_ff=bool(cfg.n_shared_experts) and fits(
                         cfg.moe_d_ff * cfg.n_shared_experts),
                     inner=cfg.family == "ssm" and bound("inner"),
                     lru=cfg.family == "hybrid" and bound("lru"))
    if cfg.family == "ssm":
        return _ssm_plan(cfg, mesh, part, multi_pod, cache, cache_leaf,
                         decode)
    if cfg.family == "hybrid" and not part.lru:
        return None
    if serve and part.heads and not part.kv:
        part = part._replace(kv_cols=fits(cfg.n_kv_heads * cfg.hd))
    if decode:
        widths = {"router": cfg.n_experts}
        if cfg.use_mla:
            widths.update(wq_a=cfg.q_lora_rank,
                          wkv_a=cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        part = part._replace(proj_cols=tuple(
            k for k, w in widths.items() if w and fits(w)))
    if cache is None:
        return part
    want = ("self_k",) if cfg.family == "audio" else ("k", "c_kv")
    if cache_leaf not in want:
        raise ValueError(f"{cfg.name}: no decode layout for a cache led by "
                         f"{cache_leaf!r}")
    if cfg.family == "audio":
        if cross is None:
            raise ValueError(f"{cfg.name}: the cross cache's shape is "
                             f"needed beside the self cache's")
        part = _cross_layout(cfg, mesh, part, multi_pod, cross)
    if part.lru:
        state = cache_pspec(("lru",), tuple(cache[:2]) + (cfg.lru_width,),
                            cfg, mesh, cache[1], multi_pod=multi_pod)
        if state[-1] != part.axis:
            raise ValueError(f"{cfg.name}: the plan splits the RG-LRU "
                             f"channels over {part.axis} but the cache's "
                             f"state does not")
    spec = cache_pspec((cache_leaf,), tuple(cache), cfg, mesh, cache[1],
                       multi_pod=multi_pod)
    seq = spec[2]
    if cache_leaf in ("k", "self_k"):
        on_heads = spec[3] is not None
        if on_heads != part.kv:
            raise ValueError(f"{cfg.name}: the cache's KV heads "
                             f"{'split' if on_heads else 'stay whole'} over "
                             f"{axis} where the plan's KV heads "
                             f"{'split' if part.kv else 'stay whole'}")
        if on_heads:
            return part._replace(cache="heads")
    if seq is None:
        return part
    return part._replace(cache="seq", seq_axes=_entry_axes(seq))


def _cross_layout(cfg, mesh, part: Partition, multi_pod: bool,
                  cross: Tuple[int, ...]) -> Partition:
    """``part`` with the enc-dec's cross cache laid out by
    ``cache_pspec`` of ``cross_k`` (global shape ``cross``): its KV heads
    (``"heads"``, as the self cache's, checked there), else its frames
    where they split (``"seq"``), else whole (``"batch"``)."""
    from repro_torch.launch.shardings import _entry_axes, cache_pspec

    spec = cache_pspec(("cross_k",), tuple(cross), cfg, mesh, cross[1],
                       multi_pod=multi_pod)
    if spec[3] is not None:
        return part._replace(cross_cache="heads")
    if spec[2] is None:
        return part
    return part._replace(cross_cache="seq",
                         cross_seq_axes=_entry_axes(spec[2]))


def _ssm_plan(cfg, mesh, part: Partition, multi_pod: bool,
              cache: Optional[Tuple[int, ...]], cache_leaf: str,
              decode: bool) -> Optional[Partition]:
    """The SSM's plan: None where ``inner`` is unbound (the gathered
    forward); decode keeps ``x_proj``'s columns and ``dt_proj``'s rows
    where their widths split; the cache (its ``ssm`` leaf's global shape)
    lies on its channels, as ``cache_pspec`` lays out ``ssm`` and
    ``conv``."""
    from repro_torch.launch.shardings import cache_pspec

    if not part.inner:
        return None
    if decode:
        widths = {"x_proj": cfg.dt_rank + 2 * cfg.ssm_state,
                  "dt_proj": cfg.dt_rank}
        part = part._replace(proj_cols=tuple(
            k for k, w in widths.items() if w >= part.n and w % part.n == 0))
    if cache is None:
        return part
    if cache_leaf != "ssm":
        raise ValueError(f"{cfg.name}: no decode layout for a cache led by "
                         f"{cache_leaf!r}")
    spec = cache_pspec(("ssm",), tuple(cache), cfg, mesh, cache[1],
                       multi_pod=multi_pod)
    if spec[2] != part.axis:
        raise ValueError(f"{cfg.name}: the plan splits the channels over "
                         f"{part.axis} but the cache's state does not")
    return part._replace(cache="inner")


def gather_proj(outs: dict, widths: dict) -> dict:
    """Decode's small projections whole: ``outs`` maps each name of
    :data:`_PROJ_LEAVES` (``router``, ``wq_a``, ``wkv_a``) to its
    product on the columns the rank holds, ``widths`` to its whole width.
    Those the rank holds as its column block (the active plan's
    :attr:`Partition.proj_cols`) are gathered in one all-gather; the others
    are whole already.  A block the plan does not account for raises."""
    split = [k for k, y in outs.items() if y.shape[-1] != widths[k]]
    if not split:
        return outs
    part = current()
    for k in split:
        if (part is None or k not in part.proj_cols
                or outs[k].shape[-1] * part.n != widths[k]):
            raise ValueError(f"{k}: the rank holds {outs[k].shape[-1]} of "
                             f"its {widths[k]} columns but the plan does "
                             f"not split them")
    return {**outs, **dict(zip(split, part.gather_cols(
        *(outs[k] for k in split))))}


def rank_kv_heads(cfg, part: Partition
                  ) -> Tuple[int, int, Optional[Tuple[int, ...]]]:
    """Where the KV heads do not split: the contiguous KV heads ``[k0,
    k1)`` this rank's query heads ``[r·H/n, (r+1)·H/n)`` read (``head =
    kv·g + i``), and, where the group does not fit them evenly, each query
    head's KV head relative to ``k0`` (else None)."""
    g = cfg.n_heads // cfg.n_kv_heads
    Hl = cfg.n_heads // part.n
    h0 = part.index * Hl
    k0, k1 = h0 // g, (h0 + Hl - 1) // g + 1
    rel = tuple(h // g - k0 for h in range(h0, h0 + Hl))
    KVl = k1 - k0
    even = Hl % KVl == 0 and rel == tuple(i // (Hl // KVl)
                                          for i in range(Hl))
    return k0, k1, None if even else rel


def _split(path: Tuple[str, ...], part: Partition) -> Optional[str]:
    """The split of the leaf at ``path`` where its product partitions
    ("col", "row", "vocab"; "head" for MLA's per-head leaves, "expert"
    for the routed experts, "narrow" for a leaf held whole of which each
    rank reads its channels), else None.  A dense leaf's path ends in its
    param name and "w" or "b" (``attn/wq/w``, ``mlp/shared/gate/w``); a
    routed expert's in its name alone (``mlp/gate``), which tells it from
    the dense MLP's, whose width is ``d_ff``, not ``moe_d_ff``.  The
    hybrid's leaves lie two keys deeper (``super/b0/temporal/w_rec/w``,
    ``tail/#1/mlp_blk/mlp/up/w``): its RG-LRU leaves resolve by
    :data:`_LRU_LEAVES`, its attention and MLP as the dense family's.  The
    enc-dec's decoder leaves lie under ``self_attn`` and ``cross_attn``
    (:data:`_ATTN_KEYS`), which resolve as ``attn``."""
    if path[:1] == ("embed",) and path[-1] == "table":
        return "vocab" if part.vocab else None
    if path[0] in _HYBRID and len(path) > 3:
        rest = path[3:]
        if part.lru and path[2] == "temporal" and rest[0] not in ("attn",
                                                                  "ln"):
            split = _LRU_LEAVES.get(rest[:1] if len(rest) == 1 else rest)
            if split == "bias":
                return "col" if path[0] in _STACKS else "narrow"
            return split
    elif path[0] not in _STACKS + _BLOCKS:
        return None
    else:
        rest = path[1:]
    if part.inner:
        key = rest[:1] if len(rest) == 1 else rest
        if key in _INNER_DECODE:
            return (_INNER_DECODE[key] if key[0] in part.proj_cols
                    else None)
        return _INNER_LEAVES.get(key)
    if len(rest) == 2 and rest[0] == "mlp" and rest[1] in _EXPERT_LEAVES:
        # the MTP block's experts split on their hidden dim (the layout's
        # expert rule keys on a stack's name): gathered
        return "expert" if part.expert and path[0] in _STACKS else None
    if len(rest) == 2 and rest[0] == "attn" and rest[1] in _HEAD_LEAVES:
        return "head" if part.heads else None
    if rest[:2] == ("mlp", "shared"):
        rest = rest[1:]
    if rest[:1] and rest[0] in _ATTN_KEYS:
        rest = ("attn",) + rest[1:]
    if len(rest) != 3 or rest[2] not in ("w", "b"):
        return None
    if rest[:2] in _PROJ_LEAVES:
        # decode's small projections (the MTP block's are never served)
        return ("col" if rest[1] in part.proj_cols and path[0] in _STACKS
                else None)
    field, split = _LEAVES.get((rest[0], rest[1]), (None, None))
    if field is None:
        return None
    on = getattr(part, field)
    if field == "kv":
        on = (on or part.kv_cols) and part.heads
    if not on:
        return None
    if rest[2] == "b" and split == "row":
        return None          # a row layer's bias is added after the sum
    return split


def model_dims(params, mdims, part: Optional[Partition]
               ) -> Tuple[Optional[int], ...]:
    """``mdims`` (each leaf's element dim on ``model``, flatten order, the
    stacked entry dim counted) with the partitioned leaves' dims dropped
    (None): those the rank keeps as its block, where the gather plan
    gathers the rest.  Each partitioned leaf's dim must be its split's:
    the last for a column split, the one before for a row split, the
    head or expert dim of a per-head or expert leaf (H, ·, ·) / (E, ·, ·),
    the table's vocab dim, none (replicated) for a narrowed one."""
    from repro_torch.tree import tree_paths

    if part is None:
        return tuple(mdims)
    out = []
    for (path, _), md in zip(tree_paths(params), mdims):
        split = _split(path, part)
        if split is None:
            out.append(md)
            continue
        # element dims: the table (V, d), a weight (L?, i, o), a bias
        # (L?, o), a per-head or expert leaf (L?, H|E, ·, ·)
        nd = {"w": 2, "b": 1}.get(path[-1], 3) + (path[0] in _STACKS)
        want = {"col": nd - 1, "row": nd - 2, "head": nd - 3,
                "expert": nd - 3, "vocab": 0, "narrow": None}[split]
        if md != want:
            raise ValueError(f"{'/'.join(path)}: the plan splits its "
                             f"{split}s over {part.axis} but the layout "
                             f"shards element dim {md}, not {want}")
        out.append(None)
    return tuple(out)


def gathered_model_leaf(path: Tuple[str, ...], md: Optional[int],
                        part: Optional[Partition]) -> bool:
    """True where a leaf sharded over ``model`` is still gathered under
    ``part`` (its product does not partition)."""
    return md is not None and (part is None or _split(path, part) is None)


def current(field: Optional[str] = None) -> Optional[Partition]:
    """The partition of the active gather plan (``models/gather``), or
    None: the layers run their whole products.  With ``field`` (the SSM's
    ``"inner"``, the hybrid's ``"lru"``), None too where that field of it
    is not set."""
    from repro_torch.models import gather as _gather

    plan = _gather.current()
    part = None if plan is None else plan.part
    if part is None or (field is not None and not getattr(part, field)):
        return None
    return part
