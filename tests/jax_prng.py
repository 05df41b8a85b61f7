"""threefry as the JAX default PRNG for the port's parity tests.

The JAX package's entry points call utils/cache.setup_runtime, which makes
rbg the process's default PRNG impl; a test that runs one in process (the
JAX CLIs' tests) leaves it so for every later test of its pytest worker.
The port's utils/prng draws threefry's stream, so a test module whose
parity rests on jax.random draws imports this fixture, which applies to the
whole module:

    from tests.jax_prng import threefry_default  # noqa: F401
"""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def threefry_default():
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)
