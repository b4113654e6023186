"""Snapshots of a mesh-sharded trainer state in the JAX package's ``.npz``
format: the same keys and the same GLOBAL layout as the JAX package writes
under a mesh, so a snapshot either package wrote under a (data, model)
grid restores into the other's ranks.  The replicated mode's state: θ
(W, ...), Θ whole, λ, h and the straggler snapshot the shard-packed (W,
d_pad) planes.  The sketched mode's: Θ whole; its (W, d_s) λ and channel
are every rank's already.

:func:`save_sharded` gathers the ranks' parts (every rank takes part in
the gathers) and rank 0 writes the file; :func:`restore_sharded` has each
rank read the file and keep its own part
(``convert.shard_fl_state``; the sketched mode's Θ shard)."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.np_checkpoint import (_SEP, _fields, _is_node,
                                                  save)
from repro_torch.convert import phy_planes, shard_fl_state
from repro_torch.core.cplx import Complex
from repro_torch.core.packing import shard_tree
from repro_torch.core.tree_ota import TreeFLState, shard_coords
from repro_torch.optim.optimizers import OptState
from repro_torch.phy.scenario import PhyState
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _grid_gather(mesh, sspec, faxes):
    """A leaf's resident block -> the whole leaf, gathered over the grid
    (``faxes``: the axes of its fsdp dim)."""
    def grid(x, md, fd, lead: int):
        if md is not None and sspec.n_model > 1:
            x = mesh.all_gather(x, "model", lead + md)
        if fd is not None and sspec.n_fsdp > 1:
            x = mesh.all_gather(x, faxes, lead + fd)
        return x
    return grid


def _grid_index(mesh, sspec, faxes) -> int:
    jm = mesh.axis_index("model") if sspec.n_model > 1 else 0
    jf = mesh.axis_index(faxes) if sspec.n_fsdp > 1 else 0
    return jf * sspec.n_model + jm


def gather_fl_state(state, mesh, sspec, faxes=("fsdp",)):
    """The GLOBAL state from every rank's part (collective: all ranks call
    it, and all get the result).  ``faxes``: the axes of the grid's fsdp
    dim (the sketched mode's ``init_fn.layout["faxes"]``)."""
    grid = _grid_gather(mesh, sspec, faxes)
    if not isinstance(state, TreeFLState):
        leaves, treedef = tree_flatten(state.Theta)
        return state._replace(Theta=tree_unflatten(treedef, [
            grid(l, md, fd, 0) for l, md, fd in
            zip(leaves, sspec.shard_dims, sspec.fsdp_dims)]))
    c = shard_coords(mesh, sspec)

    def rows(x):
        return mesh.all_gather(x, c.daxes, 0) if c.daxes else x

    def worker_tree(tree):
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            rows(grid(l, md, fd, 1)) for l, md, fd in
            zip(leaves, sspec.shard_dims, sspec.fsdp_dims)])

    def plane(x):
        return None if x is None else rows(mesh.all_gather(x, c.saxes, 1)
                                           if c.saxes else x)

    def cplane(z):
        return Complex(plane(z.re), plane(z.im))

    leaves, treedef = tree_flatten(state.Theta)
    Theta = tree_unflatten(treedef, [
        grid(l, md, fd, 0) for l, md, fd in
        zip(leaves, sspec.shard_dims, sspec.fsdp_dims)])
    opt = state.opt
    if opt is not None:
        mu = worker_tree(opt.mu)
        nu = mu if opt.nu is opt.mu else worker_tree(opt.nu)
        opt = OptState(mu=mu, nu=nu, count=opt.count)
    flt = state.flt
    if flt is not None:
        flt = flt._replace(stale=plane(flt.stale))
    chan = state.chan
    if isinstance(chan, PhyState):
        # every worker's row already; the shard grid's columns joined
        chan = phy_planes(chan, sspec.d_local, lambda x: mesh.all_gather(
            x, c.saxes, 1) if c.saxes else x)
    else:
        chan = chan._replace(h=cplane(chan.h))
    return TreeFLState(theta=worker_tree(state.theta), lam=cplane(state.lam),
                       Theta=Theta, chan=chan, opt=opt, step=state.step,
                       flt=flt)


def save_sharded(path: str, state, mesh, sspec, faxes=("fsdp",)) -> None:
    """Gather the global state and write it from rank 0 (every rank
    calls; the others wait for the file)."""
    full = gather_fl_state(state, mesh, sspec, faxes)
    if dist.get_rank() == 0:
        save(path, full)
    del full
    dist.barrier()


def _load_global(path: str, like):
    """The file's arrays in ``like``'s structure, with the file's (global)
    shapes and ``like``'s dtypes, devices and host scalars."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as zf:
        data = {k: zf[k] for k in zf.files}

    def build(x, prefix):
        if x is None:
            return None
        if _is_node(x):
            parts = list(_fields(x))
            if isinstance(x, dict):
                return {k: build(x[k], prefix + (str(k),)) for k in x}
            if isinstance(x, tuple) and hasattr(x, "_fields"):
                return type(x)(*(build(v, prefix + (p,)) for p, v in parts))
            return type(x)(build(v, prefix + (p,)) for p, v in parts)
        key = _SEP.join(prefix)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if isinstance(x, torch.Tensor):
            return torch.from_numpy(np.array(arr, order="C")).to(
                device=x.device, dtype=x.dtype)
        return type(x)(arr.item())

    return build(like, ())


def restore_sharded(path: str, like, mesh, sspec, faxes=("fsdp",)):
    """This rank's part of the global state in ``path``, shape-checked
    against ``like`` (the rank's own state, e.g. ``init_fn``'s)."""
    glob = _load_global(path, like)
    if isinstance(like, TreeFLState):
        c = shard_coords(mesh, sspec)
        out = shard_fl_state(glob, sspec, c, c.n_data)
    else:
        out = glob._replace(Theta=tree_map(torch.clone, shard_tree(
            sspec, glob.Theta, _grid_index(mesh, sspec, faxes))))
    for a, b in zip(_flat(out), _flat(like)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"restore_sharded: a leaf of shape "
                             f"{tuple(a.shape)} where the rank holds "
                             f"{tuple(b.shape)}")
    return out


def _flat(state):
    """Every tensor of a state, in a fixed walk."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif _is_node(x):
            for _, v in _fields(x):
                walk(v)
    walk(state)
    return out
