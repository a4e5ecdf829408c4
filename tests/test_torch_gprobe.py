"""The gather probe's port (``ganon_tpu_torch.ops.probe.gather_probe``)
against the Pallas kernel itself, ``scripts/pallas_gather_probe.py:28
pallas_count``, run in interpret mode on the CPU (its module loaded from
the file, its ``pl.pallas_call`` given ``interpret=True`` and its shape
constants set per case under ``monkeypatch``). Exact: the lane sums are
int32 in both."""

from __future__ import annotations

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ganon_tpu_torch.ops import probe

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "pallas_gather_probe.py")


@pytest.fixture(scope="module")
def pallas_probe():
    spec = importlib.util.spec_from_file_location("pallas_gather_probe",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(rng, R, kind):
    if kind == "ones":
        return np.full((R, probe.W8), 0xFF, dtype=np.uint8)
    return rng.integers(0, 256, size=(R, probe.W8), dtype=np.uint8)


def _rows(rng, R, n, kind):
    if kind == "one_group":  # every probe in group 5
        return (rng.integers(0, R // 16, size=n) * 16 + 5).astype(np.int32)
    if kind == "ends":  # only the first and the last row
        return np.where(rng.random(n) < 0.5, 0, R - 1).astype(np.int32)
    return rng.integers(0, R, size=n).astype(np.int32)


@pytest.mark.parametrize("R, nprobe, bt, table, rows", [
    (probe.R, 4096, 256, "random", "random"),  # the default 4 MB table
    (16, 512, 128, "random", "random"),  # the smallest table
    (1024, 2048, 256, "random", "one_group"),
    (1024, 1024, 256, "random", "ends"),
    (1024, 1024, 128, "ones", "random"),
], ids=["default_4mb", "r16", "one_group", "rows_0_and_last", "all_ones"])
def test_gather_probe_matches_pallas_interpret(pallas_probe, monkeypatch, R,
                                               nprobe, bt, table, rows):
    monkeypatch.setattr(pallas_probe, "pl", types.SimpleNamespace(
        **{**vars(pl), "pallas_call": functools.partial(pl.pallas_call,
                                                        interpret=True)}))
    monkeypatch.setattr(pallas_probe, "R", R)
    monkeypatch.setattr(pallas_probe, "NPROBE", nprobe)
    monkeypatch.setattr(pallas_probe, "BT", bt)
    rng = np.random.default_rng(R + nprobe + bt)
    tbl = _table(rng, R, table)
    r = _rows(rng, R, nprobe, rows)
    want = np.asarray(pallas_probe.pallas_count(jnp.asarray(tbl),
                                                jnp.asarray(r)))
    got = probe.gather_probe(torch.from_numpy(tbl), torch.from_numpy(r))
    assert got.dtype == torch.int32 and got.shape == (1, 128)
    assert want.dtype == np.int32 and want.shape == (1, 128)
    assert np.array_equal(got.numpy(), want)
    if table == "ones":  # 32 a word for each probe of the group
        counts = np.bincount(r & 15, minlength=16)
        assert np.array_equal(want.reshape(16, 8),
                              np.repeat(32 * counts[:, None], 8, axis=1))
