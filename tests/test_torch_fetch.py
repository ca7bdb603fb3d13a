"""The PyTorch/CUDA package's RINEX/almanac download against the JAX
package's: the station tables, station selection and URL assembly (pure),
and the download itself over loopback HTTP and FTP servers (no network).
With ``-f`` served by such a server, the port's CLI writes the bytes of
``-e`` on the same file."""

import functools
import gzip
import http.server
import random
import shutil
import threading
import time

import numpy as np
import pytest

from gpssim_tpu.io import fetch as jfetch
from gpssim_tpu_torch import cli
from gpssim_tpu_torch.core.almanac import read_sem_almanac
from gpssim_tpu_torch.core.ephemeris import read_rinex_nav
from gpssim_tpu_torch.io import fetch
from tests.test_fetch import _MiniFtpServer

#: a frozen clock (2022-01-10 07:05 UTC) and the NRT file it names
FROZEN = time.struct_time((2022, 1, 10, 7, 5, 0, 0, 10, 0))


def test_station_tables_equal_jax():
    assert fetch.STATIONS_V2 == jfetch.STATIONS_V2
    assert fetch.STATIONS_V3 == jfetch.STATIONS_V3
    assert len(fetch.STATIONS_V2) == 81  # gps.c:53-136
    assert len(fetch.STATIONS_V3) == 3  # gps.c:40-45
    assert all(len(s[0]) == 4 and len(s[1]) == 9 for s in fetch.STATIONS_V2)
    for name in ("RINEX_FTP_URL", "RINEX2_SUBFOLDER", "RINEX3_SUBFOLDER",
                 "ALMANAC_SEM_URL"):
        assert getattr(fetch, name) == getattr(jfetch, name)


@pytest.mark.parametrize("station,version", [
    ("zimm", 2), ("ZIMM00CHE", 2), ("pdel", 3), ("zzzz", 2), (None, 2),
    (None, 3),
])
def test_select_station_equal_jax(station, version):
    """By 4- or 9-char ID; an unknown ID falls back to the first station
    (gps.c:2416-2419); no ID picks at random, the same pick under the same
    seed."""
    got = fetch.select_station(station, version, rng=random.Random(7))
    assert got == jfetch.select_station(station, version,
                                        rng=random.Random(7))
    table = fetch.STATIONS_V3 if version == 3 else fetch.STATIONS_V2
    assert got in table
    if station == "zzzz":
        assert got == table[0]


@pytest.mark.parametrize("hour", [14, 0])
@pytest.mark.parametrize("version", [2, 3])
def test_rinex_url_equal_jax(hour, version):
    """The previous hour's file (gps.c:2422-2431), hour 0 wrapping to 23
    of the same day (gps.c:2424-2427)."""
    tm = time.struct_time((2022, 3, 15, hour, 5, 0, 1, 74, 0))
    got = fetch.rinex_url("zimm", tm, version=version)
    assert got == jfetch.rinex_url("zimm", tm, version=version)
    sub = "nrt_v3" if version == 3 else "nrt"
    h = 13 if hour else 23
    assert got == (f"ftp://igs.bkg.bund.de/IGS/{sub}/074/{h:02d}/"
                   f"zimm074{chr(ord('a') + h)}.22n.gz")


def test_fetch_over_local_http(fixtures_dir, tmp_path):
    """Both fetchers end to end over a loopback HTTP server: the files
    written parse."""
    serve = tmp_path / "srv"
    serve.mkdir()
    basename = fetch.rinex_url("abmf").rsplit("/", 1)[1]
    with open(f"{fixtures_dir}/brdc_test.22n", "rb") as fp:
        (serve / basename).write_bytes(gzip.compress(fp.read()))
    shutil.copy(f"{fixtures_dir}/almanac_test.sem", serve / "almanac.sem")
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(serve))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        alm = read_sem_almanac(fetch.fetch_almanac(
            out_path=str(tmp_path / "alm.sem"), url=f"{base}/almanac.sem"))
        assert any(a.svid for a in alm.sv)
        nav = read_rinex_nav(fetch.fetch_rinex(
            "abmf", out_path=str(tmp_path / "nav.gz"), base_url=base))
        assert nav.neph >= 1 and nav.sets[0].vflg.any()
        with pytest.raises(fetch.FetchError, match="almanac download"):
            fetch.fetch_almanac(out_path=str(tmp_path / "x.sem"),
                                url=f"{base}/missing.sem")
    finally:
        srv.shutdown()
        srv.server_close()


def _serve_ftp(monkeypatch, root, fixtures_dir=None):
    """A loopback FTP server at the archive root, the clock frozen; with
    ``fixtures_dir``, it holds the gzipped fixture under the name the
    clock gives station wtza."""
    if fixtures_dir is not None:
        name = fetch.rinex_url("wtza", when=FROZEN).rsplit("/", 1)[1]
        with open(f"{fixtures_dir}/brdc_test.22n", "rb") as src, \
                gzip.open(root / name, "wb") as dst:
            shutil.copyfileobj(src, dst)
    ftp = _MiniFtpServer(str(root))
    monkeypatch.setattr(fetch, "RINEX_FTP_URL",
                        f"ftp://127.0.0.1:{ftp.port}/IGS/")
    monkeypatch.setattr(fetch.time, "gmtime", lambda: FROZEN)
    return ftp


def test_fetch_over_local_ftp(fixtures_dir, tmp_path, monkeypatch):
    """The production URL is ftp:// (gps.h:24): urllib's FTP handler
    against a loopback server, the gzip payload round-tripping to the
    parser."""
    ftp = _serve_ftp(monkeypatch, tmp_path, fixtures_dir)
    out = fetch.fetch_rinex(station_id="wtza", version=2,
                            out_path=str(tmp_path / "rinex.gz"))
    ftp.close()
    assert read_rinex_nav(out, version=2).neph >= 2
    name = fetch.rinex_url("wtza", when=FROZEN).rsplit("/", 1)[1]
    assert ftp.retrieved and ftp.retrieved[0].endswith(name)


def test_fetch_ftp_error_paths(tmp_path, monkeypatch):
    """A file missing on the server is a FetchError, not a traceback
    (gps.c:2456-2466)."""
    ftp = _serve_ftp(monkeypatch, tmp_path)
    with pytest.raises(fetch.FetchError, match="RINEX download failed"):
        fetch.fetch_rinex(station_id="wtza", version=2,
                          out_path=str(tmp_path / "rinex.gz"), timeout=5.0)
    ftp.close()


def test_cli_use_ftp_equals_nav_file(fixtures_dir, tmp_path, monkeypatch):
    """``-f --station wtza`` downloads the hour's file (served here by the
    loopback FTP server) into ``rinex.gz`` and runs on it: the bytes of
    ``-e`` on the fixture. A failed download is a usage error."""
    srv = tmp_path / "srv"
    srv.mkdir()
    ftp = _serve_ftp(monkeypatch, srv, fixtures_dir)
    monkeypatch.chdir(tmp_path)
    common = ["-d", "0.3", "-l", "35.681298,139.766247,10.0",
              "--disable-almanac", "-r", "iqfile", "--device", "cpu"]
    assert cli.main(["-f", "--station", "wtza", "--out-file", "f.bin"]
                    + common) == 0
    ftp.close()
    assert (tmp_path / "rinex.gz").exists()
    assert cli.main(["-e", f"{fixtures_dir}/brdc_test.22n", "--out-file",
                     "e.bin"] + common) == 0
    got = np.fromfile(tmp_path / "f.bin", dtype=np.int8)
    assert got.size == 2 * 600_000
    assert np.array_equal(got, np.fromfile(tmp_path / "e.bin",
                                           dtype=np.int8))

    empty = tmp_path / "empty"
    empty.mkdir()
    ftp = _serve_ftp(monkeypatch, empty)
    with pytest.raises(SystemExit) as e:
        cli.main(["-f", "--station", "wtza", "--out-file", "x.bin"] + common)
    ftp.close()
    assert e.value.code == 2 and not (tmp_path / "x.bin").exists()
