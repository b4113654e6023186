"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` load no JAX and
no module of the JAX package ``repro``; entry points run on the card unless
the caller asks for the CPU; the smoke script fails without a card."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    """jax, jax.*, repro and repro.* — but not repro_torch."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.core.cplx")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.rng")


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the default device would work")


def _llm_trainer():
    from repro_torch.core.admm import AdmmConfig
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import get_model
    from repro_torch.train.llm_trainer import FLConfig, make_fl_train
    return make_fl_train(get_model("granite-8b", reduced=True),
                         FLConfig(n_workers=2), AdmmConfig(),
                         ChannelConfig(n_workers=2))


def _entry_points():
    from repro_torch import convert
    from repro_torch.benchmarks import common
    from repro_torch.data.federated import split_iid
    from repro_torch.data.synthetic import (image_dataset, linreg_dataset,
                                            token_dataset)
    from repro_torch.core import transport
    from repro_torch.models import get_model, hybrid, ssm, transformer
    from repro_torch.models.mlp import init_mlp_flat
    z = np.zeros((1, 1), np.float32)
    return {
        "token_dataset": lambda: token_dataset(0, 1, 4, 8),
        "make_fl_train": _llm_trainer,
        "Model.init": lambda: get_model("granite-8b", reduced=True).init(0),
        "transformer.init_params": lambda: transformer.init_params(
            0, get_model("granite-8b", reduced=True).cfg),
        "ssm.init_params": lambda: ssm.init_params(
            0, get_model("falcon-mamba-7b", reduced=True).cfg),
        "hybrid.init_params": lambda: hybrid.init_params(
            0, get_model("recurrentgemma-2b", reduced=True).cfg),
        "ota_accumulate_init": lambda: transport.ota_accumulate_init((4,)),
        "model_params_from_numpy": lambda: convert.model_params_from_numpy(
            {"w": z}),
        "tree_fl_state_from_numpy": lambda: convert.tree_fl_state_from_numpy(
            {"w": z}, {"w": z[0]}, z, z, z, z, 0),
        "linreg_dataset": lambda: linreg_dataset(0, n_samples=10),
        "image_dataset": lambda: image_dataset(0, 10, 10, dim=4),
        "split_iid": lambda: split_iid(0, 10, 2),
        "make_linreg_task": lambda: common.make_linreg_task(0, 2, 10),
        "make_mlp_task": lambda: common.make_mlp_task(0, 2),
        "init_mlp_flat": lambda: init_mlp_flat(0, (4, 3)),
        "mlp_flat_from_numpy": lambda: convert.mlp_flat_from_numpy(
            np.zeros(15, np.float32), (4, 3)),
        "afadmm_state_from_numpy": lambda: convert.afadmm_state_from_numpy(
            {k: np.zeros((1, 1)) for k in convert.STATE_KEYS}),
        "phy_state_from_numpy": lambda: convert.phy_state_from_numpy(
            {"h_re": np.zeros((1, 1)), "h_im": np.zeros((1, 1)), "age": 0}),
        "fault_state_from_numpy": lambda: convert.fault_state_from_numpy(
            {"alive": np.ones(1, bool), "round": 0, "n_evicted": 0}),
    }


@pytest.mark.parametrize("name", sorted(
    ["linreg_dataset", "image_dataset", "split_iid", "init_mlp_flat",
     "make_linreg_task", "make_mlp_task",
     "mlp_flat_from_numpy", "afadmm_state_from_numpy",
     "phy_state_from_numpy", "fault_state_from_numpy", "token_dataset",
     "make_fl_train", "Model.init", "transformer.init_params",
     "ssm.init_params", "hybrid.init_params", "ota_accumulate_init",
     "model_params_from_numpy", "tree_fl_state_from_numpy"]))
def test_entry_point_without_device_raises_without_cuda(name):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_llm_entry_points_default_to_the_card():
    import inspect

    from repro_torch import convert
    from repro_torch.core import transport
    from repro_torch.data.synthetic import token_dataset
    from repro_torch.models import hybrid, layers, ssm, transformer
    from repro_torch.train.llm_trainer import make_fl_train, make_replicated
    for fn in (make_fl_train, make_replicated, token_dataset,
               convert.model_params_from_numpy,
               convert.tree_fl_state_from_numpy, transformer.init_params,
               transformer.init_block, ssm.init_params, ssm.block_init,
               hybrid.init_params, hybrid.rec_block_init,
               hybrid.attn_block_init, hybrid.mlp_block_init,
               transport.ota_accumulate_init, layers.dense_init,
               layers.embedding_init, layers.attention_init, layers.mlp_init,
               layers.rmsnorm_init, layers.layernorm_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_benchmark_entry_points_default_to_the_card():
    import inspect

    from repro_torch.benchmarks import (ablation_noniid, common, fig2_linreg,
                                        fig3_classification, fig5_rho)
    from repro_torch.benchmarks.run import main
    fns = [common.make_linreg_task, common.make_mlp_task,
           ablation_noniid.ablation_noniid, fig5_rho.fig5_rho_sensitivity]
    fns += [getattr(m, n) for m in (fig2_linreg, fig3_classification)
            for n in dir(m) if n.startswith("fig")]
    assert len(fns) == 10
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "--device" in inspect.getsource(main)


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
