"""``ganon_tpu_torch.eutils`` against ``ganon_tpu.eutils`` on a local
e-utils stub (``ncbi_tree.serve_eutils``: esummary, efetch and elink in
NCBI's XML shapes, as ``tests/test_eutils.py`` serves them).

Cases: batches of 2, accessions only efetch resolves, a first attempt
that fails on every endpoint, ``level="assembly"`` with and without the
taxids, and the ``eutils_url`` and ``ncbi_api_key`` environment
variables. The port's ``run_eutils`` must equal the JAX package's
DataFrame, ``None`` where it holds NaN.
"""

import pandas as pd
import pytest

import ganon_tpu.eutils as jeu
import ganon_tpu_torch.eutils as peu
from ncbi_tree import serve_eutils

# accession -> (length, taxid, assembly uid, assembly accession, organism,
# found by esummary)
SEQS = {
    "NC_001.1": (1000, "11", "101", "GCF_000000001.1", "OrgA", True),
    "NC_002.1": (2000, "12", "102", "GCF_000000002.1", "OrgB", True),
    "NC_003.1": (3000, "21", None, None, None, False),  # efetch only
    "NC_004.1": (4000, "22", "101", "GCF_000000001.1", "OrgA", True),
    "NZ_005.2": (5000, "31", "105", "GCA_000000005.2", "OrgE", False),
}
TARGETS = ["NC_001.1", "NC_003.1", "NC_404.1", "NZ_005.2", "NC_002.1",
           "NC_004.1"]


@pytest.fixture(scope="module")
def stub():
    url, log, stop = serve_eutils(SEQS)
    yield url, log
    stop()


def _frame(df):
    return {t: {c: (None if pd.isna(v) else v) for c, v in row.items()}
            for t, row in df.to_dict("index").items()}


def _both(call):
    return call(jeu), call(peu)


def test_length_taxid_in_batches_of_two(stub):
    url, log = stub
    del log[:]
    want, got = _both(lambda m: m.EUtils(base_url=url, batch=2)
                      .length_taxid(TARGETS))
    assert got == want
    assert got["NC_003.1"] == ("3000", "21")  # through efetch
    assert "NC_404.1" not in got
    # per package: 3 esummary batches (the second, which resolves
    # nothing, tried 3 times), then efetch of what each missed
    summaries = [ids for key, ids, _ in log if key == "esummary.fcgi:nuccore"]
    assert summaries == ([TARGETS[0:2]] + [TARGETS[2:4]] * 3
                         + [TARGETS[4:6]]) * 2
    fetches = [ids for key, ids, _ in log if key.startswith("efetch")]
    assert fetches == [["NC_003.1"], ["NC_404.1", "NZ_005.2"]] * 2


def test_assembly_info_in_batches(stub):
    url, _ = stub
    want, got = _both(lambda m: m.EUtils(base_url=url, batch=4)
                      .assembly_info(TARGETS))
    assert got == want
    assert got["NC_004.1"] == ("GCF_000000001.1", "OrgA")
    assert "NC_003.1" not in got


@pytest.mark.parametrize("skip_taxid,level", [
    (False, ""), (False, "assembly"), (True, "assembly"), (True, ""),
])
def test_run_eutils_matches_jax(stub, tmp_path, skip_taxid, level):
    url, _ = stub
    info = pd.DataFrame({"node": [None] * len(TARGETS)},
                        index=pd.Index(TARGETS, name="target"), dtype=object)
    want = jeu.run_eutils(info, str(tmp_path), skip_taxid=skip_taxid,
                          level=level, base_url=url)
    got = peu.run_eutils({t: {} for t in TARGETS}, str(tmp_path),
                         skip_taxid=skip_taxid, level=level, base_url=url)
    assert list(got) == TARGETS
    assert got == _frame(want)


def test_first_attempt_fails(stub, tmp_path):
    """Every endpoint answers 500 once: the retries give what the healthy
    endpoint gives, in both packages."""
    healthy = peu.run_eutils(TARGETS, str(tmp_path), level="assembly",
                             base_url=stub[0])
    for mod, info in ((jeu, pd.DataFrame(index=pd.Index(TARGETS))),
                      (peu, TARGETS)):
        url, log, stop = serve_eutils(SEQS, fail_first=True)
        try:
            got = mod.run_eutils(info, str(tmp_path), level="assembly",
                                 base_url=url)
        finally:
            stop()
        assert (got if mod is peu else _frame(got)) == healthy
        keys = [key for key, _, _ in log]
        for key in ("esummary.fcgi:nuccore", "efetch.fcgi:nuccore",
                    "elink.fcgi:assembly", "esummary.fcgi:assembly"):
            assert keys.count(key) == 2, (mod.__name__, key)


def test_environment_variables(stub, tmp_path, monkeypatch):
    url, log = stub
    monkeypatch.setenv("eutils_url", url)
    monkeypatch.setenv("ncbi_api_key", "KEY1")
    del log[:]
    want = jeu.run_eutils(pd.DataFrame(index=pd.Index(TARGETS[:2])),
                          str(tmp_path))
    got = peu.run_eutils(TARGETS[:2], str(tmp_path))
    assert got == _frame(want)
    assert got["NC_001.1"]["node"] == "11"
    assert log and all(key_ == "KEY1" for _, _, key_ in log)
