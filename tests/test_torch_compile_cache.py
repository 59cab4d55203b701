"""The kernel build directory as a persistent compile cache
(``dcnn_tpu_torch/utils/compile_cache.py``): the twins of
``tests/test_compile_cache.py`` over ``tmp_path`` roots, with the port's
entries (``*.so`` kernel libraries, ``<library>.<pid>.tmp`` builds in
flight) in place of XLA's ``*-cache`` payloads, and the port's additions:
the root's resolution and the runtime stamp.

No compiler, no card and no subprocess: the helpers are driven directly.
"""

import json
import os

import pytest

from dcnn_tpu_torch.utils import compile_cache as cc


def _mint(root, stem):
    with open(os.path.join(root, f"lib{stem}.so"), "wb") as f:
        f.write(b"\x7fELF library")


def _tmp(root, stem, pid):
    with open(os.path.join(root, f"lib{stem}.{pid}.tmp"), "wb") as f:
        f.write(b"\x7fELF half")


def _mark_inflight(root, pid):
    d = os.path.join(root, cc._INFLIGHT)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, str(pid)), "w", encoding="utf-8") as f:
        f.write("")


DEAD = 2 ** 22 - 7  # beyond the pid space


@pytest.fixture(autouse=True)
def _isolated_sessions(monkeypatch):
    # no root of a test reaches the process's atexit commit
    monkeypatch.setattr(cc, "_SESSIONS", {})
    monkeypatch.delenv("AOT_CACHE", raising=False)
    monkeypatch.delenv("DCNN_COMPILE_CACHE", raising=False)


class TestManifestIO:
    def test_roundtrip(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, {"libb.so", "liba.so"})
        assert cc._read_committed(root) == {"liba.so", "libb.so"}

    def test_missing_manifest_reads_empty(self, tmp_path):
        assert cc._read_committed(str(tmp_path)) == set()

    def test_write_is_atomic_no_tmp_left_behind(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, {"liba.so"})
        assert [n for n in os.listdir(root) if ".tmp." in n] == []


class TestSweepUncommitted:
    def test_no_manifest_grandfathers_present_entries(self, tmp_path):
        root = str(tmp_path)
        _mint(root, "fused-aa")
        assert cc._sweep_uncommitted(root) == 0
        assert cc._read_committed(root) == {"libfused-aa.so"}
        assert os.path.exists(os.path.join(root, "libfused-aa.so"))

    def test_no_manifest_empty_root_still_arms_the_sweep(self, tmp_path):
        root = str(tmp_path)
        assert cc._sweep_uncommitted(root) == 0
        assert os.path.exists(os.path.join(root, cc._COMMITTED))
        _mint(root, "flash_fwd-poison")  # a crashed session's build
        assert cc._sweep_uncommitted(root) == 1
        assert not os.path.exists(os.path.join(root,
                                               "libflash_fwd-poison.so"))

    def test_uncommitted_entry_from_dead_writer_swept(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, {"libfused-ok.so"})
        _mint(root, "fused-ok")
        _mint(root, "conv_int8-poison")
        assert cc._sweep_uncommitted(root) == 1
        assert os.path.exists(os.path.join(root, "libfused-ok.so"))
        assert not os.path.exists(os.path.join(root,
                                               "libconv_int8-poison.so"))

    def test_live_other_enabler_blocks_sweep(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, set())
        _mint(root, "flash_bwd-fresh")
        _mark_inflight(root, 1)  # pid 1: always alive, never ours
        assert cc._sweep_uncommitted(root) == 0
        assert os.path.exists(os.path.join(root, "libflash_bwd-fresh.so"))

    def test_dead_enabler_marker_pruned_and_entry_swept(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, set())
        _mint(root, "flash_bwd-stale")
        _mark_inflight(root, DEAD)
        assert cc._sweep_uncommitted(root) == 1
        assert not os.path.exists(os.path.join(root, cc._INFLIGHT,
                                               str(DEAD)))

    def test_own_pid_marker_does_not_block(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, set())
        _mint(root, "fused-mine")
        _mark_inflight(root, os.getpid())
        assert cc._sweep_uncommitted(root) == 1


class TestFinishSessions:
    def test_commits_only_new_names_and_prunes_absent(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, {"libgone.so", "libkept.so"})
        _mint(root, "kept")
        cc._SESSIONS[root] = cc._libraries(root)  # session start
        _mint(root, "built-now")
        _mark_inflight(root, os.getpid())
        cc._finish_sessions()
        assert cc._read_committed(root) == {"libkept.so", "libbuilt-now.so"}
        assert not os.path.exists(os.path.join(root, cc._INFLIGHT,
                                               str(os.getpid())))
        assert cc._SESSIONS == {}

    def test_clean_exit_then_next_enable_keeps_entries(self, tmp_path):
        root = str(tmp_path)
        cc._write_committed(root, set())
        cc._SESSIONS[root] = cc._libraries(root)
        _mint(root, "conv3x3_tc-warm")
        cc._finish_sessions()
        assert cc._sweep_uncommitted(root) == 0
        assert os.path.exists(os.path.join(root, "libconv3x3_tc-warm.so"))


class TestTornSweepStillWorks:
    def test_build_of_a_dead_writer_dropped(self, tmp_path):
        """A killed ``nvcc`` leaves ``<library>.<pid>.tmp``: dropped when
        the pid is dead; a live writer's (here, this process's) build in
        flight and every whole library stay."""
        root = str(tmp_path)
        _mint(root, "whole")
        _tmp(root, "torn", DEAD)
        _tmp(root, "inflight", os.getpid())
        assert cc._sweep_torn_entries(root) == 1
        assert sorted(os.listdir(root)) == [
            f"libinflight.{os.getpid()}.tmp", "libwhole.so"]

    def test_missing_root_is_zero(self, tmp_path):
        assert cc._sweep_torn_entries(str(tmp_path / "nope")) == 0
        assert cc._sweep_uncommitted(str(tmp_path / "nope")) == 0


class TestRegisterSession:
    def test_snapshot_and_marker(self, tmp_path):
        root = str(tmp_path)
        _mint(root, "preexisting")
        cc._register_session(root)
        assert cc._SESSIONS[root] == {"libpreexisting.so"}
        assert os.path.exists(os.path.join(root, cc._INFLIGHT,
                                           str(os.getpid())))

    def test_idempotent_snapshot_not_retaken(self, tmp_path):
        root = str(tmp_path)
        cc._register_session(root)
        _mint(root, "after-register")
        cc._register_session(root)
        assert cc._SESSIONS[root] == set()


# -- the port's additions -------------------------------------------------------

FP = {"torch": "2.9", "cuda": "12.8", "nvcc": "V12.8.93", "capability": "9.0"}


class TestRotateIfStale:
    def test_fresh_root_is_stamped_and_keeps_its_libraries(self, tmp_path):
        root = str(tmp_path)
        _mint(root, "fused-a")
        assert cc._rotate_if_stale(root, FP) == 0
        assert os.path.exists(os.path.join(root, "libfused-a.so"))
        assert cc._read_stamp(root) == FP

    @pytest.mark.parametrize("field", sorted(FP))
    def test_another_runtime_drops_the_libraries(self, tmp_path, field):
        root = str(tmp_path)
        cc._rotate_if_stale(root, FP)
        _mint(root, "fused-a")
        _mint(root, "conv_int8-b")
        (tmp_path / "aot").mkdir()  # the executable cache is not touched
        other = dict(FP, **{field: "other"})
        assert cc._rotate_if_stale(root, other) == 2
        assert cc._libraries(root) == set()
        assert (tmp_path / "aot").is_dir()
        assert cc._read_stamp(root) == other

    def test_a_host_without_compiler_reads_no_nvcc(self, tmp_path):
        """A warm start without ``nvcc`` (None) agrees with a stamp that
        names one, and keeps that field in the stamp."""
        root = str(tmp_path)
        cc._rotate_if_stale(root, FP)
        _mint(root, "fused-a")
        assert cc._rotate_if_stale(root, dict(FP, nvcc=None)) == 0
        assert os.path.exists(os.path.join(root, "libfused-a.so"))
        assert cc._read_stamp(root) == FP

    def test_unreadable_stamp_is_stale(self, tmp_path):
        root = str(tmp_path)
        _mint(root, "fused-a")
        (tmp_path / cc._STAMP).write_text("{torn")
        assert cc._rotate_if_stale(root, FP) == 1
        assert json.loads((tmp_path / cc._STAMP).read_text()) == FP


def test_resolve_cache_root_precedence(tmp_path, monkeypatch):
    assert cc.resolve_cache_root(str(tmp_path / "arg")) == str(
        tmp_path / "arg")
    assert cc.resolve_cache_root().endswith("_build")
    monkeypatch.setenv("DCNN_COMPILE_CACHE", str(tmp_path / "legacy"))
    assert cc.resolve_cache_root(str(tmp_path / "arg")) == str(
        tmp_path / "legacy")
    monkeypatch.setenv("AOT_CACHE", str(tmp_path / "aot"))
    assert cc.resolve_cache_root(str(tmp_path / "arg")) == str(
        tmp_path / "aot")


def test_enable_compile_cache_checks_once(tmp_path, monkeypatch):
    """The first enable of a root stamps it, drops a dead writer's build
    and registers the session; a second enable of the same root checks
    nothing again."""
    root = tmp_path / "build"
    root.mkdir()
    _tmp(str(root), "torn", DEAD)
    monkeypatch.setattr(cc, "runtime_fingerprint", lambda: dict(FP))
    assert cc.enable_compile_cache(str(root)) == str(root)
    assert not (root / f"libtorn.{DEAD}.tmp").exists()
    assert cc._read_stamp(str(root)) == FP
    assert str(root) in cc._SESSIONS
    _tmp(str(root), "torn2", DEAD)
    assert cc.enable_compile_cache(str(root)) == str(root)
    assert (root / f"libtorn2.{DEAD}.tmp").exists()
