"""PyTorch port: the Level-B serving launcher (``repro_torch.launch.serve``)
against ``repro.launch.serve`` on reduced granite-moe-1b-a400m (and
the bench's other two archs, whisper-large-v3 and pixtral-12b), on the
CPU (device="cpu")."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import LoadPolicy, ServingEngine  # noqa: E402

ARCH = "granite-moe-1b-a400m"


@pytest.mark.parametrize("seed", [0, 1])
def test_skewed_workload_matches_reference(seed):
    for entries in (["generate", "score"],
                    ["generate", "vision_generate", "transcribe", "score"]):
        assert serve.skewed_workload(entries, 24, seed=seed) == \
            jserve.skewed_workload(entries, 24, seed=seed)


def _policy(name, cfg, workload):
    if name == "eager":
        return LoadPolicy.eager_all()
    if name == "lazy":
        return serve.lazy_policy()
    eng, _, _ = serve.run_service(cfg, LoadPolicy.eager_all(), workload,
                                  device="cpu")
    return LoadPolicy.from_report(eng.report())


@pytest.mark.parametrize("policy", ["eager", "lazy", "slimstart"])
def test_run_service_under_each_policy(policy):
    cfg = get_reduced(ARCH)
    entries = ServingEngine(cfg, device="cpu").entries()
    workload = serve.skewed_workload(entries, 6, seed=1)
    eng, cold, lat = serve.run_service(cfg, _policy(policy, cfg, workload),
                                       workload, seed=1, device="cpu")
    assert cold > 0
    assert sorted(lat) == sorted(set(workload))
    assert sum(len(v) for v in lat.values()) == len(workload)
    rep = eng.report()
    assert rep["entry_counts"] == {e: workload.count(e)
                                   for e in set(workload)}
    assert abs(sum(rep["expert_utilization"].values()) - 1.0) < 1e-2
    # every entry the workload hit is ready after it, whatever the policy
    for entry in set(workload):
        assert eng.registry[f"compile.{entry}"].ready


def test_lazy_cold_start_defers_experts_and_compile():
    cfg = get_reduced(ARCH)
    eng = ServingEngine(cfg, policy=serve.lazy_policy(), batch_size=1,
                        prefill_len=8, max_len=32, device="cpu")
    eng.cold_start()
    rep = eng.report()
    assert set(rep["by_group"]) == {"weights", "experts", "compile"}
    assert rep["by_group"]["experts"] == 0 and rep["by_group"]["compile"] \
        == 0
    assert rep["by_group"]["weights"] > 0
    deferred = {r["component"] for r in rep["components"] if not r["ready"]}
    assert deferred == {f"expert.{e}" for e in range(cfg.moe.n_experts)} | \
        {"compile.generate", "compile.score"}


def test_main_prints_reference_keys(monkeypatch, capsys):
    serve.main(["--device", "cpu", "--requests", "3", "--policy", "lazy"])
    got = json.loads(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", "--requests", "3",
                                     "--policy", "lazy"])
    jserve.main()
    want = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    assert got["by_group"].keys() == want["by_group"].keys()
    for key in ("arch", "policy", "entry_counts"):
        assert got[key] == want[key]


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_main_serves_frontend_archs(arch, monkeypatch, capsys):
    """The bench's other two archs through ``main`` as they are: every
    entry of the workload served (the frontend entries with zero
    extras), with the reference launcher's keys and entry counts."""
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "12",
                "--policy", "lazy", "--seed", "1"])
    got = json.loads(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--requests",
                                     "12", "--policy", "lazy", "--seed",
                                     "1"])
    jserve.main()
    want = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    assert got["by_group"].keys() == want["by_group"].keys() == \
        {"weights", "frontend", "compile"}
    for key in ("arch", "policy", "entry_counts"):
        assert got[key] == want[key]
    assert len(got["entry_counts"]) > 1  # a frontend entry was served
