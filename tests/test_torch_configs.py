"""PyTorch port: its own config copy equals the JAX package's, its entry
points refuse to fall back to the CPU, and it imports nothing of JAX."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_tpu import configs as jcfg

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "attend_infer_repeat_tpu")


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_equals_jax(name):
    assert dataclasses.asdict(tcfg.get_config(name)) == \
        dataclasses.asdict(jcfg.get_config(name))


def test_same_preset_names_and_defaults():
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    with pytest.raises(KeyError):
        tcfg.get_config("nope")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "attend_infer_repeat_torch").rglob("*.py"))
    # and what runs on the card's machine, which has no JAX
    files += [ROOT / "chip_smoke.py", *sorted(ROOT.glob("scripts/torch_*.py")),
              ROOT / "tests" / "test_torch_st_kernel_cuda.py",
              ROOT / "tests" / "helpers" / "torch_train_kill_helper.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_loads_no_jax_module():
    code = ("import sys, attend_infer_repeat_torch as air\n"
            "from attend_infer_repeat_torch import serving, convert, data\n"
            "from attend_infer_repeat_torch import eval, train\n"
            "from attend_infer_repeat_torch.train import __main__\n"
            "from attend_infer_repeat_torch.ops import st_kernel\n"
            "air.AIRModel(air.get_config('serving').model, device='cpu')\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    import attend_infer_repeat_torch as air
    from attend_infer_repeat_torch.data import make_synth_fn

    cfg = air.get_config("serving")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        air.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        air.AIRModel(cfg.model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        air.AIRModel(cfg.model, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synth_fn(cfg.data, torch.zeros((4, 16, 16)))


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    import attend_infer_repeat_torch as air
    from attend_infer_repeat_torch.data import make_synth_fn

    assert air.resolve_device("cpu") == torch.device("cpu")
    cfg = air.get_config("serving")
    model = air.AIRModel(cfg.model, use_baseline=False, device="cpu")
    assert model.device == torch.device("cpu")
    synth = make_synth_fn(cfg.data, torch.ones((4, 16, 16)), device="cpu")
    imgs, nums = synth(3, torch.Generator().manual_seed(0))
    assert imgs.shape == (3, 50, 50) and imgs.device.type == "cpu"
