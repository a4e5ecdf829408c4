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
from ganon_tpu_torch.classify.engine import ClassifyConfig, run_classify
from ganon_tpu_torch.index.ibf import build_ibf
from ganon_tpu_torch.ops.ibf_query import extract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_and_pandas():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import ganon_tpu_torch.cli, ganon_tpu_torch.classify.engine\n"
        "import ganon_tpu_torch.index.builder, ganon_tpu_torch.index.ibf\n"
        "import ganon_tpu_torch.index.hibf\n"
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
    assert not os.path.exists(str(tmp_path / "o.all"))


def test_kernel_wrappers_refuse_non_cpu_tensors_without_cuda():
    _no_cuda()
    meta = torch.zeros((4, 40 + 4), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract(meta, L1=160, L2=0, k=19, w=31, mc=130)
    assert kernels.LAUNCHES["extract"] == 0
