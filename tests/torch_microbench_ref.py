"""The reference's microbenchmark sections for
``tests/test_torch_microbench.py``, run as a script in a JAX process of its
own:

    python tests/torch_microbench_ref.py OUT_DIR SECTION [SECTION ...]

writes ``OUT_DIR/<section>.json`` as each section of
``benchmarks/kernels_microbench.py`` ends (the file renamed into place, so
a reader never sees half of one), with its ``_time`` cut to one warm-up and
one timed call (a section that raises writes its traceback under
``error``).  ``sketched_shapes`` is the reference's one-device sketched
trainer's ``d`` and ``d_s`` (the sketched section itself needs explicit
mesh axes the installed JAX refuses).  ``shard_local_microbench`` needs
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` in the
environment."""
import json
import os
import sys
import traceback

import jax

jax.config.update("jax_default_matmul_precision", "highest")

import benchmarks.kernels_microbench as km  # noqa: E402

_time = km._time
km._time = lambda fn, iters=10, warmup=3: _time(fn, iters=1, warmup=1)


def sketched_shapes() -> dict:
    """``sketched_microbench``'s trainer without a mesh: its packed ``d``
    and sketch length ``d_s``."""
    from repro.core.admm import AdmmConfig
    from repro.core.channel import ChannelConfig
    from repro.core.packing import build_packspec
    from repro.models.registry import get_model
    from repro.train.llm_trainer import FLConfig, make_fl_train

    W = 4
    flcfg = FLConfig(mode="sketched", n_workers=W, local_steps=1,
                     local_lr=1e-2, sketch_ratio=16, sketch_lr=0.7,
                     scenario="deep-fade-truncation", h_min=0.8)
    init_fn, _ = make_fl_train(get_model("granite-8b", reduced=True), flcfg,
                               AdmmConfig(rho=0.5, flip_on_change=False),
                               ChannelConfig(n_workers=W, snr_db=40.0))
    st = init_fn(jax.random.PRNGKey(0))
    return {"d": int(build_packspec(st.Theta).d),
            "d_s": int(st.lam.re.shape[-1])}


def main() -> None:
    out_dir, names = sys.argv[1], sys.argv[2:]
    for name in names:
        fn = sketched_shapes if name == "sketched_shapes" else getattr(km,
                                                                      name)
        try:
            res = fn()
        except Exception:
            res = {"error": traceback.format_exc()}
        path = os.path.join(out_dir, f"{name}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(res, f, default=str)
        os.replace(path + ".tmp", path)


if __name__ == "__main__":
    main()
