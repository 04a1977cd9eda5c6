"""What a configuration file resolves to: its reference, its counts, and
the widths the program's config is held to."""

import dataclasses
import json

import pytest

from portbench import bench, check, reference, system
from portbench.metrics import counts
from portbench.reference import model, weights

CELLS = {"granite-8b": "granite-8b.fleet_zipf",
         "olmoe-1b-7b": "olmoe-1b-7b.serve_steady"}
COUNTS = ("body_params", "attn_flops", "flash_call", "decode_call")


def _file(arch):
    return json.loads((bench.ROOT / "portbench" / "configs"
                       / f"{arch}.json").read_text())


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_the_files_keep_the_shared_reference_and_counts(arch):
    cell = bench.Cell(CELLS[arch])
    assert "reference" not in cell.cfg
    assert reference.module(cell.cfg) is None
    assert check.reference_of(cell.cfg) == (weights.draw, model.logits)
    for name in COUNTS:
        assert counts.own(cell.cfg, name) is None
        shared = getattr(counts, name).__wrapped__
        args = {"body_params": (), "attn_flops": (4, 1024 * 1025 // 2),
                "flash_call": (4, 1024), "decode_call": (4, 1100)}[name]
        assert getattr(counts, name)(cell.cfg, *args) == \
            shared(cell.cfg, *args)


def test_a_named_reference_that_is_not_there_stops_the_cell(tmp_path):
    cfg = dict(_file("granite-8b"), reference="absent")
    cfg[reference.FILE_KEY] = str(tmp_path / "absent.py")
    with pytest.raises(SystemExit, match="absent.py"):
        reference.module(cfg)
    (tmp_path / "absent.py").write_text("def draw(cfg, seed, device):\n"
                                        "    return {}\n")
    with pytest.raises(SystemExit, match="logits"):
        reference.module(cfg)


@pytest.mark.parametrize("arch", sorted(CELLS))
@pytest.mark.parametrize("size", ["published", "cpu_test"])
def test_check_widths_accepts_both_files(arch, size):
    from repro_torch.configs import get_config, get_reduced
    cfg = _file(arch)
    if size == "cpu_test":
        cfg, arch_cfg = {**cfg, **cfg["cpu_test"]}, get_reduced(arch)
    else:
        arch_cfg = get_config(arch)
    system.check_widths(cfg, arch_cfg)


@pytest.mark.parametrize("arch,key,value", [
    ("granite-8b", "window_size", 1024),
    ("granite-8b", "qkv_bias", True),
    ("granite-8b", "name", "granite-8b-other"),
    ("olmoe-1b-7b", "moe.router_noise", 0.5),
])
def test_check_widths_refuses_a_stated_field_that_differs(arch, key, value):
    from repro_torch.configs import get_config
    arch_cfg = get_config(arch)
    cfg = _file(arch)
    if key.startswith("moe."):
        cfg["moe"] = dict(cfg["moe"], **{key[4:]: value})
        same = getattr(arch_cfg.moe, key[4:])
    else:
        cfg[key] = value
        same = getattr(arch_cfg, key)
    with pytest.raises(SystemExit, match=key.replace(".", r"\.")):
        system.check_widths(cfg, arch_cfg)
    if key.startswith("moe."):
        cfg["moe"][key[4:]] = same
    else:
        cfg[key] = same
    system.check_widths(cfg, arch_cfg)


def test_check_widths_reads_a_tuple_field_as_a_json_list():
    from repro_torch.configs import get_config
    arch_cfg = dataclasses.replace(get_config("granite-8b"),
                                   window_pattern=("local", "global"))
    cfg = dict(_file("granite-8b"), window_pattern=["local", "global"])
    system.check_widths(cfg, arch_cfg)
    cfg["window_pattern"] = ["global"]
    with pytest.raises(SystemExit, match="window_pattern"):
        system.check_widths(cfg, arch_cfg)
