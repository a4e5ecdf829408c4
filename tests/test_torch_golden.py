"""Frozen per-read counts of the golden filters, reproduced by the port.

``tests/fixtures/golden_h1.ibf`` / ``golden_h4.ibf`` are reference
(cereal) archives with classify counts frozen in ``golden.json``
(tests/test_golden_fixtures.py). The port does not read cereal yet, so
the JAX package's loader reads each fixture, the port's ``IBF`` takes
its arrays and saves an npz, and the port's engine classifies the frozen
reads from it. The counts must equal the frozen ones exactly; they pin
the hash family, the seeds and the minimizer emission.
"""

import json
import os

import pytest

import ganon_tpu  # noqa: F401
from ganon_tpu.index.serialize import read_ibf
from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
from ganon_tpu_torch.index.ibf import IBF

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("name", ["golden_h1.ibf", "golden_h4.ibf"])
def test_port_counts_match_frozen(name, tmp_path):
    with open(os.path.join(FIXDIR, "golden.json")) as f:
        m = json.load(f)[name]
    ref = read_ibf(os.path.join(FIXDIR, name))
    db = str(tmp_path / "golden.ibf")
    IBF.from_arrays(ref.bits, ref.ibf_config.to_dict(), ref.hashes_count,
                    ref.bin_map).save(db)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for rid, s in m["reads"].items():
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
    out = str(tmp_path / "res")
    run_classify(ClassifyConfig(
        ibf=[db], single_reads=[str(fq)], output_prefix=out,
        rel_cutoff=[0.001], rel_filter=[1.0], fpr_query=[1.0],
        output_all=True, quiet=True, device="cpu",
    ))
    counts = {}
    with open(out + ".all") as f:
        for line in f:
            rid, t, c = line.rstrip("\n").split("\t")
            counts.setdefault(rid, {})[t] = int(c)
    assert counts == m["counts"]
