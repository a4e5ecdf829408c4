"""Whole runs of the harness on the CPU at a small size: a sound run is
correct; the control and each fault a cell can have are not. Plus the
import checks, the harness's refusal without a card, and the card's own
run of the control (marked ``cuda``)."""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench.harness import runner, spec

ROOT = spec.ROOT
SMALL = {"arc_ibf_short": {"species": 3, "sample": 1500},
         "viral_hibf_short": {"species": 60, "sample": 4000},
         "arc_ibf_build": {"targets": 6}}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(name, tmp_path, seed=2**31 + 11, scale=None, control=False):
    return runner.run(spec.Cell(name), seed, 0.5, False, device="cpu",
                      t_process=time.monotonic(),
                      scale=scale or SMALL[name], control=control,
                      work=str(tmp_path / "work"))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    out = _run(name, tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    # without a card there is no device trace: the host's metrics only
    names = {m["name"] for m in spec.Cell(name).end_to_end
             if m["source"] == "host_clock"}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_its_per_layer_metrics(name, tmp_path):
    """A traced run on the CPU reports the per-layer metrics that need no
    device trace, the classify cells' wall rate among them."""
    out = runner.run(spec.Cell(name), 2**31 + 11, 0.5, True, device="cpu",
                     t_process=time.monotonic(), scale=SMALL[name],
                     work=str(tmp_path / "work"))
    assert out["correct"], out["checks"]
    cell = spec.Cell(name)
    want = {m["name"] for m in cell.per_layer
            if m["source"] != "device_trace"}
    assert want <= set(out["metrics"])
    if cell.traffic["kind"] == "classify":
        assert out["metrics"]["classify.wall_mbp_per_min"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    out = _run(name, tmp_path, control=True)
    assert not out["correct"], out["checks"]


def _classify_fault(kind):
    from ganon_tpu_torch.classify import device as dev

    def wrap(real):
        def f(*a, **kw):
            res = real(*a, **kw)
            n = res["n_matches"]
            if kind == "half":  # half of the batch left out
                n[::2] = 0
            else:  # one answer altered where it is produced
                hit = np.flatnonzero(n > 0)
                if len(hit):
                    res["top_idx"][hit[0], 0] += 1
            return res
        return f

    return [(dev, "unpack_batch_result_ragged",
             wrap(dev.unpack_batch_result_ragged)),
            (dev, "unpack_batch_result", wrap(dev.unpack_batch_result))]


def _build_fault(kind):
    from ganon_tpu_torch.index import builder

    real = builder._finish_build

    def finish(cfg, ibf, stats, phases=None, mark=None):
        bits = np.array(ibf.bits)
        if kind == "half":  # half of the targets' bins left out
            bits[:, : bits.shape[1] // 2] = 0
        else:  # one bit of the answer altered
            bits[0, 0] ^= 1
        ibf.bits = bits
        return real(cfg, ibf, stats, phases, mark)

    return [(builder, "_finish_build", finish)]


@pytest.mark.parametrize("kind", ["half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, kind, tmp_path, monkeypatch):
    make = (_build_fault if spec.Cell(name).traffic["kind"] == "build"
            else _classify_fault)
    seen = {}

    def setup_then_break(self, real=runner.KINDS[
            spec.Cell(name).traffic["kind"]][0].setup):
        real(self)
        for obj, attr, fn in make(kind):
            monkeypatch.setattr(obj, attr, fn)
        seen["broken"] = True

    cls = runner.KINDS[spec.Cell(name).traffic["kind"]][0]
    monkeypatch.setattr(cls, "setup", setup_then_break)
    out = _run(name, tmp_path)
    assert seen["broken"]
    assert not out["correct"], out["checks"]


def _half_rows(monkeypatch):
    """The program's filters sized at half the rows: the flat sizing's bin
    size, and the pruned layout's fine and coarse bin sizes, halved."""
    from ganon_tpu_torch.index import pruned, sizing

    size_filter, bin_size = sizing.size_filter, pruned.bin_size_fp_hf

    def half(*a, **kw):
        cfg = size_filter(*a, **kw)
        cfg.bin_size_bits = -(-cfg.bin_size_bits // 2)
        return cfg

    monkeypatch.setattr(sizing, "size_filter", half)
    monkeypatch.setattr(pruned, "bin_size_fp_hf",
                        lambda fp, n, h: -(-bin_size(fp, n, h) // 2))


@pytest.mark.parametrize("name", CELLS)
def test_filter_at_half_the_rows_is_not_correct(name, tmp_path,
                                                monkeypatch):
    """A program that sizes its filter below the configured max-fp is
    caught by the filter's own check, whatever it then classifies."""
    _half_rows(monkeypatch)
    out = _run(name, tmp_path)
    key = ("build_mismatch" if spec.Cell(name).traffic["kind"] == "build"
           else "filter_mismatch")
    assert out["checks"][key]["value"] > 0 and not out["correct"]


def _top_level_names(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split())


def test_no_jax_module_in_a_whole_run():
    """A fresh process runs a cell on the CPU through the harness and
    lists every loaded module's top-level name, compared whole
    (``ganon_tpu_torch`` starts with ``ganon_tpu``)."""
    code = (
        "import sys, time, importlib.util, tempfile\n"
        "sys.path.insert(0, '.')\n"
        "s = importlib.util.spec_from_file_location('pb_run', "
        "'portbench/run.py')\n"
        "importlib.util.module_from_spec(s)\n"
        "from portbench.harness import spec, runner\n"
        f"runner.run(spec.Cell('arc_ibf_short'), 5, 0.2, False, "
        f"device='cpu', t_process=time.monotonic(), scale={SMALL['arc_ibf_short']!r}, "
        "work=tempfile.mkdtemp())\n"
        "for m in spec.benchmark()['per_layer']: spec.metric_reader(m['name'])\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    names = _top_level_names(code)
    assert "ganon_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ganon_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.ganon_ref\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert not names & {"jax", "jaxlib", "flax", "ganon_tpu",
                        "ganon_tpu_torch"}


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_checkout_of_only_the_benchmark_fails(tmp_path):
    """Without the program beside it the harness cannot run a cell."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from portbench.harness import spec, runner\n"
            "runner.run(spec.Cell('arc_ibf_short'), 5, 0.2, False, "
            "device='cpu', t_process=time.monotonic(), "
            f"scale={SMALL['arc_ibf_short']!r})\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "ganon_tpu_torch" in p.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name, card, tmp_path):
    """The control at a size a test run holds, on the card: not correct;
    the program on the same seed: correct."""
    scale = {"arc_ibf_short": {"species": 16, "sample": 16384},
             "viral_hibf_short": {"species": 200, "sample": 16384},
             "arc_ibf_build": {"targets": 16}}[name]
    for seed in (101, 2**31 + 5, 77):
        kw = dict(device=card, t_process=time.monotonic(), scale=scale,
                  work=str(tmp_path / "work"))
        ok = runner.run(spec.Cell(name), seed, 1.0, False, **kw)
        ctl = runner.run(spec.Cell(name), seed, 1.0, False, control=True,
                         **kw)
        assert ok["correct"], ok["checks"]
        assert not ctl["correct"], ctl["checks"]
