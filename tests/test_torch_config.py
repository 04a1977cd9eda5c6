"""PyTorch port: configs match the reference, and the port stays free of
JAX and of the ``repro`` package."""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import param_count as t_param_count  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_arch_ids_match():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_config_asdict_matches_reference(arch):
    assert dataclasses.asdict(tcfgs.get_config(arch)) == \
        dataclasses.asdict(jcfgs.get_config(arch))
    assert dataclasses.asdict(tcfgs.get_reduced(arch)) == \
        dataclasses.asdict(jcfgs.get_reduced(arch))
    cfg = tcfgs.get_config(arch)
    assert cfg.param_count() == jcfgs.get_config(arch).param_count()
    assert cfg.tdtype == getattr(torch, cfg.dtype)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2.5-32b",
                                  "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "olmoe-1b-7b",
                                  "whisper-large-v3", "pixtral-12b"])
def test_param_count_matches_reference(arch):
    assert t_param_count(tcfgs.get_config(arch)) == \
        j_param_count(jcfgs.get_config(arch))
    assert t_param_count(tcfgs.get_reduced(arch)) == \
        j_param_count(jcfgs.get_reduced(arch))


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tcfgs.get_config("no-such-arch")


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.configs, repro_torch.models\n"
        "import repro_torch.models.convert, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref, repro_torch.serving\n"
        "import repro_torch.launch.serve, repro_torch.serving.graphs\n"
        "import repro_torch.serving.batcher, repro_torch.obs.tracing\n"
        "import repro_torch.obs.metrics, repro_torch.pool.sharing\n"
        "import repro_torch.api.artifacts\n"
        "import repro_torch.examples.serve_continuous\n"
        "import repro_torch.examples.quickstart\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_no_jax_or_repro_import_in_source():
    offenders = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.name}: {n}")
    assert not offenders, offenders
