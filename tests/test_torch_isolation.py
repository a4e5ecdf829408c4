"""The port stands alone: no jax, no pandas, no CPU fallback for CUDA.

The machine with the card has neither jax nor pandas, so the port must
import without them; and asking for ``device="cuda"`` where there is no
CUDA must fail, never quietly run on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ganon_tpu_torch import kernels
from ganon_tpu_torch.build import build_custom
from ganon_tpu_torch.config import Config
from ganon_tpu_torch.index.device_build import DeviceBuildPipeline
from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
from ganon_tpu_torch.index.ibf import build_ibf
from ganon_tpu_torch.index.pruned import build_pruned
from ganon_tpu_torch.ops.ibf_query import extract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_and_pandas():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import ganon_tpu_torch.cli, ganon_tpu_torch.classify.engine\n"
        "import ganon_tpu_torch.index.builder, ganon_tpu_torch.index.ibf\n"
        "import ganon_tpu_torch.index.hibf, ganon_tpu_torch.index.pruned\n"
        "import ganon_tpu_torch.index.serialize\n"
        "import ganon_tpu_torch.ops.pruned_query\n"
        "import ganon_tpu_torch.build, ganon_tpu_torch.taxonomy\n"
        "import ganon_tpu_torch.index.device_build\n"
        "import ganon_tpu_torch.ops.build_ops\n"
        "assert not any(m == 'ganon_tpu' or m.startswith('ganon_tpu.')"
        " for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_reassign_and_report_run_without_jax_and_pandas(tmp_path):
    """EM reassignment (whose ``.all`` reader is pandas in the JAX
    package), the report and the classify command import and run with
    jax and pandas blocked."""
    (tmp_path / "r.all").write_text("a\tS1\t9\nb\tS1\t7\nb\tS2\t7\n")
    (tmp_path / "r.rep").write_text(
        "H1\tS1\t2\t1\t0\tspecies\tS1\nH1\tS2\t1\t0\t0\tspecies\tS2\n"
        "#total_classified\t2\n#total_unclassified\t1\n")
    (tmp_path / "db.tax").write_text(
        "1\t0\troot\troot\t100\nS1\t1\tspecies\tS1\t50\n"
        "S2\t1\tspecies\tS2\t60\n")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import ganon_tpu_torch.commands, ganon_tpu_torch.report\n"
        "from ganon_tpu_torch.cli import main\n"
        f"d = {str(tmp_path)!r}\n"
        "assert main('reassign', input_prefix=[d + '/r'], quiet=True)\n"
        "assert main('report', input=[d + '/r.rep'], db_prefix=[d + '/db'],"
        " output_prefix=d + '/t', quiet=True)\n"
        "assert not any(m == 'ganon_tpu' or m.startswith('ganon_tpu.')"
        " for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert (tmp_path / "r.one").read_text() == "a\tS1\t9\nb\tS1\t7\n"
    assert (tmp_path / "t.tre").stat().st_size > 0


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA behaviour is not testable")


def test_cuda_device_without_cuda_raises(tmp_path):
    _no_cuda()
    db = str(tmp_path / "db.ibf")
    rng = np.random.default_rng(0)
    build_ibf({"T0": np.unique(rng.integers(0, 2**63, 100, dtype=np.uint64))},
              kmer_size=19, window_size=31, device="cpu").save(db)
    fq = tmp_path / "r.fq"
    fq.write_text("@r\n" + "ACGT" * 40 + "\n+\n" + "I" * 160 + "\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_classify(ClassifyConfig(ibf=[db], single_reads=[str(fq)],
                                    output_prefix=str(tmp_path / "o")))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_ibf({"T0": np.arange(1, 50, dtype=np.uint64)}, kmer_size=19,
                  window_size=31)
    with pytest.raises(RuntimeError, match="CUDA"):  # the default: the card
        build_pruned({"T0": np.arange(1, 50, dtype=np.uint64)},
                     kmer_size=19, window_size=31)
    assert not os.path.exists(str(tmp_path / "o.all"))


def test_build_defaults_without_cuda_raise(tmp_path):
    """build_custom and DeviceBuildPipeline default to the card: without
    CUDA both raise, and build_custom writes nothing first."""
    _no_cuda()
    fa = tmp_path / "a.fna"
    fa.write_text(">s\n" + "ACGT" * 100 + "\n")
    cfg = Config("build-custom", db_prefix=str(tmp_path / "db" / "x"),
                 input=[str(fa)], taxonomy="skip", quiet=True)
    cfg.validate()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_custom(cfg)
    assert not (tmp_path / "db").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBuildPipeline(19, 31)


def test_kernel_wrappers_refuse_non_cpu_tensors_without_cuda():
    _no_cuda()
    meta = torch.zeros((4, 40 + 4), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract(meta, L1=160, L2=0, k=19, w=31, mc=130)
    assert kernels.LAUNCHES["extract"] == 0
