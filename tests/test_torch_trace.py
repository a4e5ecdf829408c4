"""The span and counter recorder (``ganon_tpu_torch.trace``) and the
spans the port records through it.

The recorder alone: nesting and self time, worker-thread spans under the
submitting root, the caps on roots and events, ``record_function`` only
while torch's profiler is on, and its clock against a CPU profiler
trace. Then the port: a tiny ``build-custom`` and ``classify`` through
``cli.main(..., device="cpu")`` record the documented spans and counters,
``run_classify``'s ``timing`` equals its root's totals and the build's
StopClock phases keep their five names; and the engine's exact path
counts no batch's finish twice.
"""

import json
import random
import threading
import time
from collections import deque

import pytest
import torch

from ganon_tpu_torch import cli, trace
from ganon_tpu_torch.classify import engine
from ganon_tpu_torch.io.pipeline import ThreadedBatchSource
from ganon_tpu_torch.index import builder


def _names(root):
    return {e.name for e in root.events}


def test_nesting_self_time_and_totals():
    with trace.span("cmd.nest") as top:
        with trace.span("a", level="H1") as a:
            time.sleep(0.02)
            with trace.span("b"):
                time.sleep(0.03)
            with trace.span("b"):
                # a span nested in one of its own name counts its wall
                # once
                with trace.span("b"):
                    time.sleep(0.01)
        trace.count("n", 2)
        trace.count("n")
        trace.high("q", 3)
        trace.high("q", 1)
    root = top.root
    assert root.name == "cmd.nest" and trace.records()[-1] is root
    t = trace.totals([root])
    s = t["spans"]
    assert s["a"]["count"] == 1 and s["b"]["count"] == 3
    b_wall = sum(e.wall_ns for e in root.events
                 if e.name == "b" and e.parent == a.id) / 1e9
    assert s["b"]["wall_s"] == pytest.approx(b_wall)
    assert s["a"]["self_s"] == pytest.approx(a.wall_s - b_wall)
    assert 0.02 <= s["a"]["self_s"] < a.wall_s
    assert s["b"]["self_s"] == pytest.approx(b_wall)
    assert s["cmd.nest"]["wall_s"] == top.wall_s == root.wall_s
    assert s["cmd.nest"]["self_s"] == pytest.approx(top.wall_s - a.wall_s)
    assert t["counters"] == {"n": 3, "q": 3}
    ev = {e.id: e for e in root.events}
    assert ev[a.id].parent == top.id and ev[a.id].attrs == {"level": "H1"}
    assert ev[top.id].parent == 0
    # every child lies inside its parent on the recorded clock
    for e in root.events:
        if e.parent:
            p = ev[e.parent]
            assert p.start_ns <= e.start_ns
            assert e.start_ns + e.wall_ns <= p.start_ns + p.wall_ns
    assert s["a"]["cpu_s"] is not None
    table = trace.table(root)
    assert table.splitlines()[1].startswith("cmd.nest")
    assert "\n  a " in table and "\n    b " in table and "counter" in table


def test_spans_without_the_cpu_clock(monkeypatch):
    """Per-batch spans skip the thread CPU clock (a system call): they
    record no CPU time, and never read that clock."""
    with trace.span("cmd.cpu") as top:
        with trace.span("lean", cpu=False, reads=3) as lean:
            clock = trace.time

            class NoThreadClock:
                time_ns = staticmethod(clock.time_ns)
                perf_counter_ns = staticmethod(clock.perf_counter_ns)

                @staticmethod
                def thread_time_ns():
                    raise AssertionError("thread CPU clock read")

            monkeypatch.setattr(trace, "time", NoThreadClock)
            with trace.span("inner", cpu=False):
                pass
            monkeypatch.setattr(trace, "time", clock)
    root = top.root
    t = trace.totals([root, root])
    assert lean.cpu_s is None and t["spans"]["lean"]["cpu_s"] is None
    assert t["spans"]["lean"]["count"] == 2
    assert t["spans"]["cmd.cpu"]["cpu_s"] == 2 * top.cpu_s
    ev = {e.name: e for e in root.events}
    assert ev["lean"].cpu_ns is None and ev["lean"].attrs == {"reads": 3}
    assert ev["cmd.cpu"].cpu_ns is not None
    row = next(r for r in trace.table(root).splitlines() if "lean" in r)
    assert row.split()[3] == "-"


def test_span_without_a_root_starts_one():
    with trace.span("alone") as sp:
        pass
    assert sp.root.name == "alone" and trace.records("alone")[-1] is sp.root
    trace.count("outside")  # no root open: recorded nowhere
    assert all("outside" not in r.counters for r in trace.records())


def test_worker_spans_go_to_the_submitting_root():
    seen = {}

    def worker(token):
        with trace.within(token):
            with trace.span("work"):
                time.sleep(0.01)
            trace.count("worked")
        with trace.span("stray"):  # no carried root: a root of its own
            pass
        seen["done"] = True

    with trace.span("cmd.submit") as top:
        with trace.span("submit") as sub:
            t = threading.Thread(target=worker, args=(trace.carry(),),
                                 name="helper")
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen["done"]
    root = top.root
    work = [e for e in root.events if e.name == "work"]
    assert len(work) == 1 and work[0].parent == sub.id
    assert work[0].thread == "helper"
    assert root.counters["worked"] == 1
    # the worker's time is not taken off its submitter's self time
    assert root.spans["submit"][2] == pytest.approx(sub.wall_s)
    assert "stray" not in _names(root)

    # a carried token with no root records nothing
    def no_root(token):
        with trace.within(token):
            with trace.span("lost") as sp:
                pass
        seen["lost"] = sp

    t = threading.Thread(target=no_root, args=((None, None),))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen["lost"].root is None


def test_threaded_source_and_writer_carry_the_root(tmp_path):
    with trace.span("cmd.threads") as top:
        src = ThreadedBatchSource(iter([[1, 2], [3]]), max_queued=1)
        assert [len(x) for x in src] == [2, 1]
        out = engine._Out()
        out.submit(str(tmp_path / "o.txt"), lambda: "line\n")
        out.close_all()
    root = top.root
    parse = [e for e in root.events if e.name == "parse.batch"]
    assert len(parse) == 3  # two items, then the end of the generator
    assert [e.attrs for e in parse[:2]] == [{"reads": 2}, {"reads": 1}]
    assert {e.thread for e in parse} == {"ganon-parser"}
    assert root.highs["parse.queue_max"] >= 1
    fmt = [e for e in root.events if e.name.startswith("writer.")]
    assert {e.name for e in fmt} == {"writer.format", "writer.write"}
    assert {e.thread for e in fmt} == {"ganon-writer"}
    assert "finish.submit" in _names(root)
    assert (tmp_path / "o.txt").read_text() == "line\n"


def test_root_and_event_caps(monkeypatch):
    monkeypatch.setattr(trace, "_roots", deque(maxlen=3))
    monkeypatch.setattr(trace, "EVENTS", 5)
    for i in range(5):
        with trace.span("cmd.cap") as top:
            for _ in range(9):
                with trace.span("x"):
                    pass
    roots = trace.records("cmd.cap")
    assert len(roots) == 3 and roots[-1] is top.root
    assert [r.id for r in roots] == sorted(r.id for r in roots)
    assert trace.records("cmd.cap", last=2) == roots[1:]
    assert trace.records("cmd.cap", last=0) == []
    root = top.root
    assert len(root.events) == 5
    assert root.counters["trace.dropped"] == 5  # 10 spans, 5 kept
    assert root.spans["x"][0] == 9  # the aggregates keep every span
    assert trace.totals(roots)["counters"]["trace.dropped"] == 15


def test_record_function_only_while_the_profiler_is_on(monkeypatch):
    opened = []

    class Fake:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Fake)
    with trace.span("cmd.off"):
        with trace.span("off"):
            pass
    assert opened == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)

    def worker(token):
        with trace.within(token):
            with trace.span("worker"):
                pass

    with trace.span("cmd.on"):
        with trace.span("on"):
            t = threading.Thread(target=worker, args=(trace.carry(),))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    # main-thread spans only: the profiler keeps no other thread's
    assert opened == ["span.cmd.on", "span.on"]


def test_spans_share_the_device_trace_clock(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("warm"):  # the profiler's first annotation
            pass
        with trace.span("cmd.clock") as top:
            with trace.span("engine.run"):
                time.sleep(0.005)
                out = engine._Out()
                out.submit(str(tmp_path / "o.txt"),
                           lambda: time.sleep(0.005) or "x\n")
                out.close_all()
            with trace.span("reassign.parse"):
                time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_us = doc["baseTimeNanoseconds"] / 1000
    marks = {e["name"][5:]: (e["ts"] + base_us, e["ts"] + e["dur"] + base_us)
             for e in doc["traceEvents"]
             if str(e.get("name", "")).startswith("span.")}
    root = top.root
    main = [e for e in root.events if e.thread == threading.main_thread().name]
    assert {e.name for e in main} == {"cmd.clock", "engine.run",
                                      "reassign.parse", "finish.submit"}
    for e in main:
        assert abs(marks[e.name][0] - e.start_ns / 1000) < 1000, e.name
    # the writer's spans are not in the profiler's trace, but on its clock
    # they lie inside their root's annotation
    lo, hi = marks["cmd.clock"]
    writer = [e for e in root.events if e.name.startswith("writer.")]
    assert writer and all(e.name not in marks for e in writer)
    for e in writer:
        assert lo <= e.start_ns / 1000
        assert e.start_ns / 1000 + e.wall_ns / 1000 <= hi


# --------------------------------------------------------------------------
# the port's spans through the CLI


K, W = 19, 31


def _genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A 6-target database built through ``build-custom`` on the CPU
    (the StopClock phases kept as the benchmark reads them), and paired
    reads of its genomes."""
    tmp = tmp_path_factory.mktemp("trace")
    rng = random.Random(5)
    core = _genome(rng, 500)
    refs = {f"T{t}": (core if t % 2 else "") + _genome(rng, 3000)
            for t in range(6)}
    rows, nodes, names = [], [], []
    for g in range(2):
        nodes.append(f"{100 + g}\t|\t1\t|\tgenus\t|\n")
        names.append(f"{100 + g}\t|\tG{g}\t|\t\t|\tscientific name\t|\n")
    for t, (name, seq) in enumerate(refs.items()):
        p = tmp / f"{name}.fna"
        p.write_text(f">{name} x\n{seq}\n")
        nodes.append(f"{200 + t}\t|\t{100 + t % 2}\t|\tspecies\t|\n")
        names.append(f"{200 + t}\t|\tS{t}\t|\t\t|\tscientific name\t|\n")
        rows.append(f"{p}\t{name}\t{200 + t}\n")
    (tmp / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\n" + "".join(nodes))
    (tmp / "names.dmp").write_text("1\t|\troot\t|\t\t|\tscientific name\t|\n"
                                   + "".join(names))
    (tmp / "input.tsv").write_text("".join(rows))
    phases = []
    real = builder._finish_build

    def finish(cfg, ibf, stats, ph=None, mark=None):
        out = real(cfg, ibf, stats, ph, mark)
        phases.append(list(ph or []))
        return out

    builder._finish_build = finish
    try:
        assert cli.main("build-custom", input_file=str(tmp / "input.tsv"),
                        db_prefix=str(tmp / "db"), taxonomy="ncbi",
                        taxonomy_files=[str(tmp / "nodes.dmp"),
                                        str(tmp / "names.dmp")],
                        skip_genome_size=True, max_fp=0.05, kmer_size=K,
                        window_size=W, device="cpu", quiet=True)
    finally:
        builder._finish_build = real
    build_root = trace.records("cmd.build_custom")[-1]
    with open(tmp / "r1.fq", "w") as f1, open(tmp / "r2.fq", "w") as f2:
        names = sorted(refs)
        for i in range(300):
            seq = refs[names[i % len(names)]]
            s = rng.randrange(len(seq) - 150)
            f1.write(f"@q{i}\n{seq[s:s + 150]}\n+\n{'I' * 150}\n")
            f2.write(f"@q{i}\n{_revcomp(seq[s:s + 150])}\n+\n{'I' * 150}\n")
    return tmp, phases, build_root


def test_build_custom_records_its_phases(db):
    _, phases, root = db
    assert [p[0] for p in phases[0]] == ["Ingest", "Count", "EstimateParams",
                                         "BuildIBF", "WriteIBF"]
    spans = trace.totals([root])["spans"]
    for label, name in zip(("Ingest", "Count", "EstimateParams", "BuildIBF",
                            "WriteIBF"),
                           ("build.ingest", "build.count", "build.estimate",
                            "build.scatter", "build.write")):
        assert dict(phases[0])[label] == spans[name]["wall_s"]
        assert root.parents[name] == "cmd.build_custom"
    assert "build.prepare" in spans


def _classify(db, out, **kw):
    tmp = db[0]
    return cli.main("classify", db_prefix=[str(tmp / "db")],
                    paired_reads=[str(tmp / "r1.fq"), str(tmp / "r2.fq")],
                    output_prefix=str(out), device="cpu",
                    **{"quiet": True, **kw})


def test_classify_records_the_documented_spans(db, tmp_path, monkeypatch):
    kept = {}
    real = engine.run_classify

    def run(cfg):
        kept["stats"] = real(cfg)
        return kept["stats"]

    monkeypatch.setattr(engine, "run_classify", run)
    assert _classify(db, tmp_path / "o", n_reads=64, output_all=True)
    root = trace.records("cmd.classify")[-1]
    t = trace.totals([root])
    spans, counters = t["spans"], t["counters"]
    assert set(spans) >= {
        "cmd.classify", "engine.run", "engine.context", "engine.input_wait",
        "engine.dispatch", "dispatch.pack", "dispatch.upload",
        "dispatch.enqueue", "dispatch.copy", "engine.finish", "finish.fetch",
        "finish.unpack", "finish.assign", "finish.submit", "engine.drain",
        "engine.rep", "writer.format", "writer.write", "parse.batch",
        "reassign.parse", "reassign.em", "reassign.write", "report.tax",
        "report.tree"}
    assert {"engine.batches", "engine.reads", "engine.bases",
            "transfer.h2d_bytes", "transfer.d2h_bytes",
            "transfer.dense_bytes", "writer.queue_max",
            "parse.queue_max"} <= set(counters)
    assert counters["engine.reads"] == 300
    assert counters["engine.bases"] == 300 * 300
    assert counters["engine.batches"] == spans["engine.dispatch"]["count"]
    assert spans["engine.dispatch"]["count"] >= 5
    assert root.parents["engine.run"] == "cmd.classify"
    assert root.parents["dispatch.upload"] == "engine.dispatch"
    assert root.parents["finish.fetch"] == "engine.finish"
    assert root.parents["reassign.em"] == "cmd.classify"
    # the per-batch spans carry their level and read count
    disp = [e for e in root.events if e.name == "engine.dispatch"]
    assert sum(e.attrs["reads"] for e in disp) == 300
    assert {e.attrs["level"] for e in disp} == {"H1"}
    # run_classify's timing is a view of the root's totals
    timing = kept["stats"]["timing"]
    for key, name in (("input_wait", "engine.input_wait"),
                      ("dispatch", "engine.dispatch"),
                      ("fetch", "finish.fetch"), ("finish", "engine.finish"),
                      ("total", "engine.run")):
        assert timing[key] == spans[name]["wall_s"], key
    # each level's transfer counts what the counters sum
    tr = kept["stats"]["transfer"]["H1"]
    assert tr["fetched_bytes"] == counters["transfer.d2h_bytes"]
    assert tr["dense_bytes"] == counters["transfer.dense_bytes"]


def test_verbose_prints_the_span_table(db, tmp_path, capsys):
    assert _classify(db, tmp_path / "v", n_reads=128, verbose=True,
                     quiet=False)
    err = capsys.readouterr().err
    assert "\ncmd.classify " in err and "\n  engine.run " in err
    assert "\n    engine.dispatch " in err and "\n  reassign.parse " in err
    assert "engine.batches" in err


def test_exact_path_counts_each_finish_once(db, tmp_path, monkeypatch):
    """A batch that takes the exact path while others are in flight
    finishes those first: each batch's finish is counted once, so the
    disjoint parts of the run add up to no more than its total."""
    real_dispatch = engine._dispatch_batch_fast
    real_finish = engine._finish_batch_fast
    calls = {"n": 0}

    def dispatch(batch, ctx, cfg):
        calls["n"] += 1
        return None if calls["n"] % 3 == 0 else real_dispatch(batch, ctx, cfg)

    def finish(*a, **kw):
        time.sleep(0.05)  # a slow finish, so a double count shows
        return real_finish(*a, **kw)

    kept = {}
    real_run = engine.run_classify

    def run(cfg):
        kept["stats"] = real_run(cfg)
        return kept["stats"]

    monkeypatch.setattr(engine, "_dispatch_batch_fast", dispatch)
    monkeypatch.setattr(engine, "_finish_batch_fast", finish)
    monkeypatch.setattr(engine, "run_classify", run)
    assert _classify(db, tmp_path / "x", n_reads=32, pipeline_depth=4)
    root = trace.records("cmd.classify")[-1]
    assert root.counters["engine.exact_batches"] >= 2
    timing = kept["stats"]["timing"]
    parts = timing["input_wait"] + timing["dispatch"] + timing["finish"]
    assert timing["finish"] <= timing["total"]
    assert parts <= timing["total"]
