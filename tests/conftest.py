import os
import subprocess
import sys

# Tests run single-device in-process (multi-device tests go through the
# forced_devices subprocess fixture below).  Keep XLA quiet and
# deterministic.
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'src'))

import pytest  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORCE_FLAG = '--xla_force_host_platform_device_count'


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA card; skips without one (decided by a '
                   'fixture when the test runs)')


def backend_initialized() -> bool:
    """True once jax has instantiated a backend in THIS process — the
    device count is locked from then on, so XLA_FLAGS edits are silently
    ignored."""
    if 'jax' not in sys.modules:
        return False
    from jax._src import xla_bridge
    return xla_bridge.backends_are_initialized()


def _merge_xla_flags(flags: str, n: int) -> str:
    kept = [f for f in flags.split() if not f.startswith(_FORCE_FLAG)]
    return ' '.join(kept + [f'{_FORCE_FLAG}={n}'])


def force_host_device_count(n: int) -> None:
    """Force ``n`` virtual host devices in THIS process.

    Legal only before jax initializes its backend: afterwards the count
    is locked and mutating ``XLA_FLAGS`` does nothing — the historical
    test_moe_ep.py bug this guard exists to catch (it overwrote the env
    var inside an embedded script; harmless there because the subprocess
    had not touched jax yet, but silently wrong anywhere else).  Raises
    ``RuntimeError`` instead of failing silently; tests that need a
    different device count use the :func:`forced_devices` fixture, which
    runs them in a fresh subprocess.
    """
    if backend_initialized():
        raise RuntimeError(
            f'cannot force {n} host devices: the jax backend is already '
            f'initialized in this process and its device count is '
            f'locked — run under the forced_devices subprocess fixture '
            f'instead')
    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['XLA_FLAGS'] = _merge_xla_flags(
        os.environ.get('XLA_FLAGS', ''), n)


def forced_device_env(n: int) -> dict:
    """A subprocess environment with ``n`` forced host devices: CPU
    platform, merged ``XLA_FLAGS``, ``PYTHONPATH`` covering src/."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env['XLA_FLAGS'] = _merge_xla_flags(env.get('XLA_FLAGS', ''), n)
    path = env.get('PYTHONPATH', '')
    src = os.path.join(REPO_ROOT, 'src')
    env['PYTHONPATH'] = src + (os.pathsep + path if path else '')
    return env


@pytest.fixture(scope='session')
def forced_devices():
    """Run a python script under ``n`` forced virtual host devices in a
    fresh subprocess (the only safe way once this process's backend is
    up).  Returns the CompletedProcess; asserts on failure with the
    child's output so the report is readable."""
    def run(script: str, n: int = 8, timeout: float = 600.0,
            check: bool = True):
        r = subprocess.run([sys.executable, '-c', script],
                           env=forced_device_env(n), capture_output=True,
                           text=True, timeout=timeout, cwd=REPO_ROOT)
        if check:
            assert r.returncode == 0, (
                f'forced-{n}-device subprocess failed '
                f'(rc={r.returncode})\nstdout={r.stdout}\n'
                f'stderr={r.stderr[-4000:]}')
        return r
    return run
