"""bin/fqz5 fast-start launcher: correctness + no eager jax import."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FQZ5 = os.path.join(REPO, "bin", "fqz5")


@pytest.mark.skipif(not os.path.exists(FQZ5), reason="launcher missing")
def test_launcher_roundtrip(tmp_path, data_dir):
    sample = str(data_dir / "sample.fastq")
    arc = tmp_path / "s.fqz5"
    out = tmp_path / "s.fastq"
    r = subprocess.run([FQZ5, "-3", sample, str(arc)], capture_output=True)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([FQZ5, "-d", str(arc), str(out)],
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == open(sample, "rb").read()
    # archive matches the in-process encoder byte-for-byte
    from fqzcomp5_tpu.cli import main
    arc2 = tmp_path / "s2.fqz5"
    assert main(["-3", sample, str(arc2)]) == 0
    assert arc.read_bytes() == arc2.read_bytes()


@pytest.mark.skipif(not os.path.exists(FQZ5), reason="launcher missing")
def test_launcher_host_path_never_imports_jax(tmp_path, data_dir):
    """Host-engine runs must not pay the jax import (the whole point
    of the launcher)."""
    probe = (
        "import sys, os\n"
        "sys.path.insert(0, os.path.join({repo!r}, 'bin'))\n"
        "sys.path.insert(0, {repo!r})\n"
        "from fqzcomp5_tpu.cli import main\n"
        "rc = main(['-1', {sample!r}, {out!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'host path imported jax'\n"
        "print('OK')\n"
    ).format(repo=REPO, sample=str(data_dir / "sample.fastq"),
             out=str(tmp_path / "o.fqz5"))
    r = subprocess.run([sys.executable, "-c", probe],
                       capture_output=True, text=True)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout, r.stderr)


@pytest.mark.skipif(not os.path.exists(FQZ5), reason="launcher missing")
def test_cli_path_never_imports_numpy(tmp_path, data_dir):
    """Encode AND decode of clean FASTQ must stay numpy-free: numpy is
    ~300ms of cold-start (utils/lazy_np.py), 75%+ of the boot budget
    the reference binary doesn't pay."""
    probe = (
        "import sys, os\n"
        "sys.path.insert(0, os.path.join({repo!r}, 'bin'))\n"
        "sys.path.insert(0, {repo!r})\n"
        "from fqzcomp5_tpu.cli import main\n"
        "arc, out = {arc!r}, {out!r}\n"
        "assert main(['-3', {sample!r}, arc]) == 0\n"
        "assert 'numpy' not in sys.modules, 'encode imported numpy'\n"
        "assert main(['-d', arc, out]) == 0\n"
        "assert 'numpy' not in sys.modules, 'decode imported numpy'\n"
        "assert open(out, 'rb').read() == open({sample!r}, 'rb').read()\n"
        "print('OK')\n"
    ).format(repo=REPO, sample=str(data_dir / "sample.fastq"),
             arc=str(tmp_path / "n.fqz5"), out=str(tmp_path / "n.out"))
    r = subprocess.run([sys.executable, "-c", probe],
                       capture_output=True, text=True)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout, r.stderr)
