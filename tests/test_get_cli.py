"""Tests for the get command and CLI plumbing."""

import os
import subprocess
import sys

import pytest

from groot_tpu.get import get_database

DB_DIR = "/root/reference/db/clustered-ARG-databases/1.1"


def test_get_from_local_source(tmp_path, require_files):
    require_files(DB_DIR)
    out = get_database(
        "arg-annot", "90", str(tmp_path), source=DB_DIR
    )
    assert os.path.isdir(out)
    msas = [f for f in os.listdir(out) if f.endswith(".msa")]
    assert len(msas) >= 583  # arg-annot.90 ships ~600 cluster MSAs


def test_get_md5_mismatch(tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "arg-annot.90.tar", "wb") as fh:
        fh.write(b"corrupt")
    with pytest.raises(ValueError, match="md5sum mismatch"):
        get_database("arg-annot", "90", str(tmp_path / "o"), source=str(bad))


def test_get_unknown_db(tmp_path):
    with pytest.raises(ValueError, match="unrecognised database"):
        get_database("nope", "90", str(tmp_path))


def test_cli_version_and_help():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="/root/repo")
    out = subprocess.run(
        [sys.executable, "-m", "groot_tpu.cli", "version"],
        capture_output=True,
        text=True,
        env=env,
    )
    assert out.returncode == 0
    assert out.stdout.strip() == "1.1.2"
    out = subprocess.run(
        [sys.executable, "-m", "groot_tpu.cli", "--help"],
        capture_output=True,
        text=True,
        env=env,
    )
    assert out.returncode == 0
    for cmd in ("get", "index", "align", "report", "haplotype", "accuracy"):
        assert cmd in out.stdout
