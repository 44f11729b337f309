"""The backend switch, the compile cache, and the CLI's use of both."""

import contextlib
import io
import json
import os

import jax
import pytest

from qmmx_monolithic_monte_carlo_tpu import backend as B
from qmmx_monolithic_monte_carlo_tpu.host import cli


@pytest.mark.parametrize("requested,platform,reason,want", [
    ("auto", "cpu", None, "xla"),
    ("auto", "gpu", None, "triton"),
    ("auto", "gpu", "the kernel runs the gbm sampler only", "xla"),
    ("xla", "gpu", None, "xla"),
    ("xla", "cpu", "anything", "xla"),
    ("triton", "gpu", None, "triton"),
])
def test_resolve_picks_the_backend(requested, platform, reason, want):
    assert B.resolve(requested, kernel_reason=reason, platform_name=platform) == want


@pytest.mark.parametrize("requested,platform,reason,match", [
    ("triton", "cpu", None, "needs a GPU"),
    ("triton", "gpu", "the kernel runs the gbm sampler only", "gbm sampler"),
    ("pallas", "gpu", None, "unknown backend"),
])
def test_resolve_refuses_what_cannot_run(requested, platform, reason, match):
    with pytest.raises(B.BackendError, match=match):
        B.resolve(requested, kernel_reason=reason, platform_name=platform)


def test_resolve_reads_the_default_device():
    assert B.platform() == jax.devices()[0].platform == "cpu"
    assert B.resolve("auto") == "xla"


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    env = os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    yield
    jax.config.update("jax_compilation_cache_dir", before)
    if env is not None:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = env


def test_compile_cache_defaults_to_a_fixed_path_in_the_checkout(restore_cache_dir):
    got = B.setup_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(B.__file__)))
    assert got == os.path.join(repo, ".jax_cache") == B.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == got
    assert B.setup_compile_cache() == got          # the same path every time


def test_compile_cache_honours_the_environment(restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    assert B.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None   # JAX reads the variable


def _parse(*argv):
    return cli.build_parser().parse_args(list(argv))


@pytest.mark.parametrize("cmd,backend,ok", [
    ("paths", "triton", True), ("paths", "xla", True),
    ("book", "triton", False), ("flywheel", "triton", False),
    ("book", "xla", False),
])
def test_cli_lists_only_backends_that_run(cmd, backend, ok):
    """Only ``paths`` has a choice; the other subcommands run on XLA and
    take no ``--backend``."""
    if ok:
        assert _parse(cmd, "--backend", backend).backend == backend
    else:
        with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
            _parse(cmd, "--backend", backend)


@pytest.mark.parametrize("flags,reason", [
    ([], None),
    (["--engine"], "first-contact"),
    (["--gated"], "first-contact"),
    (["--exact-tail"], "exact-tail"),
    (["--sampler", "heston"], "gbm"),
    (["--num-paths", "1000"], "multiple"),
    (["--num-bars", "41"], "even"),
])
def test_paths_names_why_the_kernel_cannot_run(flags, reason):
    from qmmx_monolithic_monte_carlo_tpu.types import Levels

    args = _parse("paths", *flags)
    levels = Levels.from_rows([{"color": "blue", "type": "solid", "index": 0,
                                "price": 100.0}], max_levels=64)
    got = cli._kernel_reason(args, levels, args.sampler)
    assert (got is None) if reason is None else (reason in got)


def _run_paths(tmp_path, *flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--db", str(tmp_path / "q.db"), "paths", "--num-paths", "1024",
                  "--num-bars", "16", *flags])
    return json.loads(buf.getvalue().splitlines()[-1])


def test_paths_json_names_the_backend(tmp_path):
    row = _run_paths(tmp_path)
    assert row["backend"] == "xla" and row["paths"] == 1024.0


def test_paths_refuses_triton_without_a_gpu(tmp_path):
    with pytest.raises(SystemExit, match="needs a GPU"):
        _run_paths(tmp_path, "--backend", "triton")


def test_first_contact_paths_on_xla_is_the_pipeline():
    """The runner that ``paths`` and ``bench.py`` share: ``xla`` is
    ``pathsim.mc_paths`` with the block size capped at the path count."""
    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu.sim import pathsim
    from qmmx_monolithic_monte_carlo_tpu.types import Levels

    levels = Levels.from_rows([{"color": "blue", "type": "solid", "index": 0,
                                "price": 100.0}], max_levels=8)
    params = EngineParams.default()
    got = B.first_contact_paths("xla", 3, levels, params, num_paths=512,
                                num_bars=16, s0=100.0, sigma=0.3,
                                block_paths=1 << 20)
    want = pathsim.mc_paths(jax.random.key(3), levels, params, num_paths=512,
                            num_bars=16, s0=100.0, sigma=0.3, block_paths=512)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert (g == w).all()
