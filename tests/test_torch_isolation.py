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
