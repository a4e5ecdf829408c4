"""``classify --distributed``: the port's multi-process classify.

``shard_reads`` and ``host_output_prefix`` against the JAX package's on
the cases of ``tests/test_multihost.py``; then two real processes of the
port's CLI (``main(..., device="cpu")``) joined by ``torch.distributed``
over gloo through the launcher's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): rank ``i`` writes
``out.h{i}.*``, and the union of the two ranks' outputs equals one
process's run of the same inputs, both when the files are split between
the ranks and when one file's records are striped over them. Each
process has a time limit, so a hung rank fails its test.
"""

import os
import random
import socket
import subprocess
import sys

import pytest

from ganon_tpu.parallel import multihost as jmulti
from ganon_tpu_torch.cli import main
from ganon_tpu_torch.parallel import multihost as tmulti
from tests.test_classify import build_db, read_tsv, write_fastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("single,paired,batch,n", [
    ([], ["a.1", "a.2", "b.1", "b.2", "c.1", "c.2"], [], 2),
    (["big.fq"], [], [], 4),
    (["r1.fq", "r2.fq"], [], [], 4),
    (["s.fq"], ["p.1", "p.2"], [], 2),
    (["x"], ["a", "b"], ["t"], 1),
    (["x", "y", "z"], ["a", "b"], ["t", "u"], 3),
])
def test_shard_reads_matches_jax(single, paired, batch, n):
    for i in range(n):
        assert (tmulti.shard_reads(single, paired, batch, i, n)
                == jmulti.shard_reads(single, paired, batch, i, n))


@pytest.mark.parametrize("prefix,i,n", [("out", 2, 4), ("out", 0, 1),
                                        ("", 1, 4), ("a/b", 1, 2)])
def test_host_output_prefix_matches_jax(prefix, i, n):
    assert (tmulti.host_output_prefix(prefix, i, n)
            == jmulti.host_output_prefix(prefix, i, n))


def test_single_process_is_rank_zero_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmulti.maybe_initialize() == (0, 1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(kwargs: dict, world: int = 2, timeout: int = 120):
    """``world`` processes of ``main('classify', device='cpu',
    distributed=True, **kwargs)``; each must exit 0 within ``timeout``."""
    port = _free_port()
    code = ("from ganon_tpu_torch.cli import main\n"
            f"assert main('classify', device='cpu', distributed=True, "
            f"**{kwargs!r})\n")
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]


def _refs(seed, n):
    rng = random.Random(seed)
    refs = {f"T{i}": "".join(rng.choice("ACGT") for _ in range(400))
            for i in range(n)}
    return rng, refs


def _totals(path):
    return {r[0]: int(r[1]) for r in read_tsv(path) if r[0].startswith("#")}


@pytest.mark.parametrize("case", ["files", "striped"])
def test_two_process_classify_union_equals_one_run(tmp_path, case):
    rng, refs = _refs(9 if case == "files" else 11, 6)
    db = build_db(tmp_path, refs, k=10, w=12, max_fp=0.01)
    names = sorted(refs)
    files = []
    for h in range(2 if case == "files" else 1):
        reads = {}
        for i in range(30 if case == "files" else 50):
            t = names[(i + h) % len(names)]
            s = rng.randint(0, 330)
            reads[f"h{h}q{i}"] = refs[t][s:s + rng.randint(20, 60)]
        fq = tmp_path / f"r{h}.fq"
        write_fastq(fq, reads)
        files.append(str(fq))
    kw = dict(db_prefix=[db[:-4]], single_reads=files, output_all=True,
              output_unclassified=True, rel_cutoff=[0.3], rel_filter=[0.3],
              multiple_matches="skip", quiet=True)
    solo = str(tmp_path / "solo")
    assert main("classify", device="cpu", output_prefix=solo, **kw)
    out = str(tmp_path / "dist")
    _run_ranks(dict(output_prefix=out, **kw))
    for ext in (".all", ".unc"):
        parts = [sorted(map(tuple, read_tsv(f"{out}.h{r}{ext}")))
                 for r in range(2)]
        if ext == ".all":
            assert all(parts)  # both ranks did work
        assert sorted(parts[0] + parts[1]) == sorted(
            map(tuple, read_tsv(solo + ext))), ext
    t0, t1 = _totals(out + ".h0.rep"), _totals(out + ".h1.rep")
    for key, v in _totals(solo + ".rep").items():
        assert t0.get(key, 0) + t1.get(key, 0) == v, key
