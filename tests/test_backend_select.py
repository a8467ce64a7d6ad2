"""Engine and mesh choice, backend errors, the compile-cache location and
the native library's rebuild trigger."""

import logging
from pathlib import Path

import jax
import pytest

from matchtigs_tpu import native, testing
from matchtigs_tpu.algos import greedytigs as gt
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu.utils import compile_cache


@pytest.fixture
def one_cpu_device(monkeypatch):
    first = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: first)


def test_auto_engine_runs_the_kernel_on_the_virtual_mesh(caplog):
    assert len(jax.devices()) == 8
    with caplog.at_level(logging.WARNING, logger=gt.__name__):
        assert not gt._use_host_engine(gt.GreedytigConfig(k=13))
    assert "engine=auto: device kernel on 8 cpu device(s)" in caplog.text
    assert gt._want_mesh(gt.GreedytigConfig(k=13))


def test_auto_engine_runs_host_on_one_cpu_device(one_cpu_device, caplog):
    with caplog.at_level(logging.WARNING, logger=gt.__name__):
        assert gt._use_host_engine(gt.GreedytigConfig(k=13))
    assert "engine=auto: native host Dijkstra" in caplog.text
    assert not gt._want_mesh(gt.GreedytigConfig(k=13))


@pytest.mark.parametrize("engine, host", [("host", True), ("device", False)])
def test_forced_engine_is_obeyed(one_cpu_device, engine, host):
    assert gt._use_host_engine(gt.GreedytigConfig(k=13, engine=engine)) is host


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        gt._use_host_engine(gt.GreedytigConfig(k=13, engine="bogus"))


def test_backend_init_error_raises(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("backend failed to initialise")

    monkeypatch.setattr(jax, "devices", broken)
    store, _, k = testing.make_unitig_store(genome_length=3000, k=11, seed=0)
    g = build_bigraph_from_unitigs(store, k)
    with pytest.raises(RuntimeError, match="failed to initialise"):
        gt.compute_greedytigs(g, gt.GreedytigConfig(k=k))
    with pytest.raises(RuntimeError, match="failed to initialise"):
        gt._want_mesh(gt.GreedytigConfig(k=k, engine="device"))


def test_host_engine_never_touches_the_backend(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("backend failed to initialise")

    store, _, k = testing.make_unitig_store(genome_length=3000, k=11, seed=0)
    want = gt.compute_greedytigs(
        build_bigraph_from_unitigs(store, k),
        gt.GreedytigConfig(k=k, engine="host", use_mesh=False),
    )
    monkeypatch.setattr(jax, "devices", broken)
    got = gt.compute_greedytigs(
        build_bigraph_from_unitigs(store, k),
        gt.GreedytigConfig(k=k, engine="host"),
    )
    assert got.offsets.tolist() == want.offsets.tolist()
    assert got.flat.tolist() == want.flat.tolist()


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env_cache"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "env_cache")
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_the_checkout(monkeypatch, tmp_path):
    repo = Path(__file__).resolve().parents[1]
    assert compile_cache.DEFAULT_DIR == repo / ".jax_cache"
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", tmp_path / ".jax_cache")
    assert compile_cache.enable_compile_cache() == str(tmp_path / ".jax_cache")
    assert (tmp_path / ".jax_cache").is_dir()
    assert calls == [("jax_compilation_cache_dir", str(tmp_path / ".jax_cache"))]


def test_native_rebuild_triggers_on_flag_or_isa_change(monkeypatch):
    native.load()
    assert not native._needs_rebuild()
    monkeypatch.setattr(native, "_CXX_FLAGS", native._CXX_FLAGS + ["-g"])
    assert native._needs_rebuild()
    monkeypatch.undo()
    monkeypatch.setattr(native, "_host_isa", lambda: "another-cpu")
    assert native._needs_rebuild()
