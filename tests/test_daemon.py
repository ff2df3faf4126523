"""fqz5 daemon mode: pre-warmed fork-per-request CLI server.

Covers the protocol (ping/stop), byte-identical output vs a direct
in-process run, stdio fd passing (stdout/stderr redirection and pipe
output), exit-code relay for usage errors, client fallback when no
daemon is up, and the FQZ5_DAEMON launcher routing.
"""
import os
import subprocess
import sys
import time

import pytest

from fqzcomp5_tpu import daemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FQZ5 = os.path.join(REPO, "bin", "fqz5")


@pytest.fixture()
def live_daemon(tmp_path):
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-c",
         "from fqzcomp5_tpu.daemon import serve; "
         f"raise SystemExit(serve({sock!r}, quiet=True))"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if daemon.request(sock, None, op="ping"):
            break
        if p.poll() is not None:
            raise RuntimeError(
                f"daemon died: {p.stderr.read().decode()[-400:]}")
        time.sleep(0.1)
    else:
        p.kill()
        raise RuntimeError("daemon never answered ping")
    yield sock
    daemon.stop(sock)
    try:
        p.wait(timeout=10)
    except subprocess.TimeoutExpired:
        p.kill()


def test_daemon_ping_and_stop(live_daemon):
    assert daemon.request(live_daemon, None, op="ping") is True


def test_daemon_encode_matches_direct(live_daemon, tmp_path, data_dir):
    sample = str(data_dir / "sample.fastq")
    arc_d = tmp_path / "via_daemon.fqz5"
    rc = daemon.request(live_daemon, ["-3", sample, str(arc_d)])
    assert rc == 0
    from fqzcomp5_tpu.cli import main

    arc_p = tmp_path / "direct.fqz5"
    assert main(["-3", sample, str(arc_p)]) == 0
    assert arc_d.read_bytes() == arc_p.read_bytes()

    out = tmp_path / "rt.fastq"
    assert daemon.request(live_daemon,
                          ["-d", str(arc_d), str(out)]) == 0
    assert out.read_bytes() == open(sample, "rb").read()


def test_daemon_relays_exit_codes(live_daemon, tmp_path):
    # missing input file -> ERROR + rc 1, daemon stays alive
    rc = daemon.request(live_daemon,
                        ["-1", str(tmp_path / "nope.fastq"),
                         str(tmp_path / "o.fqz5")])
    assert rc == 1
    assert daemon.request(live_daemon, None, op="ping") is True


def test_daemon_requests_are_isolated(live_daemon, tmp_path, data_dir):
    """A failing request must not poison the next one (fork-per-request
    isolation)."""
    sample = str(data_dir / "sample.fastq")
    assert daemon.request(live_daemon, ["-d", sample,
                                        str(tmp_path / "x")]) == 1
    arc = tmp_path / "ok.fqz5"
    assert daemon.request(live_daemon, ["-1", sample, str(arc)]) == 0
    assert arc.stat().st_size > 0


def test_daemon_declines_device_engine(live_daemon, tmp_path, data_dir):
    """`-e tpu` jobs are declined (one JAX process per card): the
    client gets None and runs the job itself."""
    sample = str(data_dir / "sample.fastq")
    out = tmp_path / "dev.fqz5"
    assert daemon.request(live_daemon, ["-e", "tpu", sample,
                                        str(out)]) is None
    assert not out.exists()
    # the daemon keeps serving host jobs
    assert daemon.request(live_daemon, ["-1", sample,
                                        str(tmp_path / "h.fqz5")]) == 0


def test_client_fallback_without_daemon(tmp_path):
    assert daemon.request(str(tmp_path / "absent.sock"), ["-1"]) is None
    assert daemon.request(str(tmp_path / "absent.sock"), None,
                          op="ping") is None


@pytest.mark.skipif(not os.path.exists(FQZ5), reason="launcher missing")
def test_launcher_routes_through_daemon(live_daemon, tmp_path, data_dir):
    """bin/fqz5 with FQZ5_DAEMON set runs via the daemon (stdout comes
    through the passed fd) and produces the same archive bytes."""
    sample = str(data_dir / "sample.fastq")
    arc = tmp_path / "l.fqz5"
    env = dict(os.environ)
    env["FQZ5_DAEMON"] = live_daemon
    r = subprocess.run([FQZ5, "-1", "-v", sample, str(arc)],
                       capture_output=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    from fqzcomp5_tpu.cli import main

    arc_p = tmp_path / "p.fqz5"
    assert main(["-1", sample, str(arc_p)]) == 0
    assert arc.read_bytes() == arc_p.read_bytes()

    # decode to stdout through the daemon: bytes arrive on the pipe
    r = subprocess.run([FQZ5, "-d", str(arc), "-"],
                       capture_output=True, env=env, timeout=120)
    if r.returncode == 0 and r.stdout:
        assert r.stdout == open(sample, "rb").read()


@pytest.mark.skipif(not os.path.exists(FQZ5), reason="launcher missing")
def test_daemon_cli_verbs(tmp_path, data_dir):
    """--daemon serves, --daemon-stop shuts it down, stale socket is
    reclaimed."""
    sock = str(tmp_path / "v.sock")
    # stale socket file (no listener) must be reclaimed by serve()
    import socket as socket_m

    s = socket_m.socket(socket_m.AF_UNIX)
    s.bind(sock)
    s.close()  # leaves a dead socket file behind

    env = dict(os.environ)
    p = subprocess.Popen([FQZ5, "--daemon", sock], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if daemon.request(sock, None, op="ping"):
            break
        if p.poll() is not None:
            raise RuntimeError(
                f"--daemon died: {p.stderr.read().decode()[-400:]}")
        time.sleep(0.1)
    else:
        p.kill()
        raise RuntimeError("--daemon never answered ping")

    r = subprocess.run([FQZ5, "--daemon-stop", sock],
                       capture_output=True, timeout=30)
    assert r.returncode == 0, r.stderr
    p.wait(timeout=10)
    assert not os.path.exists(sock)
    # stopping again reports no daemon
    r = subprocess.run([FQZ5, "--daemon-stop", sock],
                       capture_output=True, timeout=30)
    assert r.returncode == 1
