"""The port stands alone: pafuse_tpu_torch and chip_smoke.py import neither
jax nor any module of pafuse_tpu, and entry points never fall back to the
CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pafuse_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "chip_ab.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pafuse_tpu")


def test_no_forbidden_imports_in_source():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0 and _forbidden(node.module):
                    bad.append((path, node.module))
    assert not bad, bad


def test_package_imports_without_jax_or_pafuse_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import pafuse_tpu_torch\n"
        "for m in pkgutil.walk_packages(pafuse_tpu_torch.__path__,"
        " 'pafuse_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n, m in sys.modules.items() if m is not None and"
        " (n == 'pafuse_tpu' or n.startswith(('pafuse_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "for m in ('pafuse_tpu_torch.serve', 'pafuse_tpu_torch.cli.serve',"
        " 'pafuse_tpu_torch.utils.device', 'pafuse_tpu_torch.data.dhp3',"
        " 'pafuse_tpu_torch.cli.main_3dhp', 'pafuse_tpu_torch.cli.in_the_wild',"
        " 'pafuse_tpu_torch.cli.draw_h3wb', 'pafuse_tpu_torch.viz',"
        " 'pafuse_tpu_torch.parallel.mesh',"
        " 'pafuse_tpu_torch.utils.observability',"
        " 'pafuse_tpu_torch.runtime', 'pafuse_tpu_torch.dryrun',"
        " 'pafuse_tpu_torch.models.packed'):\n"
        "    assert m in sys.modules, m\n"
        "assert not sys.modules['pafuse_tpu_torch.runtime']._LIBS\n"
        "assert 'matplotlib' not in sys.modules and 'cv2' not in sys.modules\n"
        "assert 'tensorboardX' not in sys.modules\n"
        "assert 'torch.utils.tensorboard' not in sys.modules\n"
        "print('ok', len([n for n in sys.modules"
        " if n.startswith('pafuse_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    assert int(r.stdout.split()[1]) >= 32


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the CPU-only refusal cannot be shown")
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models.mixste import MixSTE2, MixSTEConfig
    from pafuse_tpu_torch.train import create_train_state
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MixSTE2(MixSTEConfig(depth=1, embed_dim=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D3DP(D3DPConfig(depth=1))
    # the trainer moves the model to CUDA unless the CPU is asked for
    model = D3DP(D3DPConfig(depth=1, frames=9), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(model)
    assert next(model.parameters()).device.type == "cpu"
    # the service and its CLI serve on CUDA unless the CPU is asked for
    from pafuse_tpu_torch.cli.serve import build_service
    from pafuse_tpu_torch.config import load_config
    from pafuse_tpu_torch.serve import LiftingService
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiftingService(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_service(load_config(overrides=["model.dep=1"]), warmup=False)
    assert next(model.parameters()).device.type == "cpu"
    # so do the 3DHP, in-the-wild and draw CLIs
    from pafuse_tpu_torch.cli import draw_h3wb, in_the_wild, main_3dhp
    for cli in (main_3dhp, in_the_wild, draw_h3wb):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["model.dep=1"])
    # so do the data-parallel world and a service over several devices
    from pafuse_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiftingService(model, device="cpu", devices=["cuda:0", "cuda:1"])


def test_kernel_wrappers_refuse_cuda_tensors_without_a_kernel():
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    takes the plain version.  Without a card the CUDA path cannot be
    reached, so this checks the device dispatch on a device that is neither
    (it must raise, not fall back)."""
    from pafuse_tpu_torch.ops.block_train import (TrainSaved, block_train_bwd,
                                                  block_train_fwd)
    x = torch.empty(2, 5, 32, device="meta")
    m = torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        block_train_fwd(x, m, m, [], 8)
    with pytest.raises(ValueError, match="unsupported device"):
        block_train_bwd(TrainSaved(x, m, m, (), 8, None), x)


def test_resolve_device_turns_tf32_off():
    from pafuse_tpu_torch.utils.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")
