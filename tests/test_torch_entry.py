"""The port's entry points (``sickle_tpu_torch/entry.py``) against the JAX
package's ``__graft_entry__.py`` on the CPU.

``entry(device="cpu")`` runs the cuts kernel's plain version on the same
example batch as the JAX ``entry()``: five and three equal, and the same
``first_bad < lengths`` (the kernel reports a flag, not a position).
``dryrun_multichip(n, device="cpu")`` runs the sharded step over ``n``
copies of the CPU device.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from sickle_tpu_torch import entry


def test_example_batch_is_the_jax_one():
    for b, l in ((256, 256), (24, 128)):
        for got, want in zip(entry._example_batch(b, l),
                             jax_entry._example_batch(b, l)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_entry_matches_jax():
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    five, three, bad = (x.numpy() for x in fn(*args))
    jfn, jargs = jax_entry.entry()
    jfive, jthree, jbad = (np.asarray(x) for x in jax.jit(jfn)(*jargs))
    lengths = jargs[2]
    assert np.array_equal(five, jfive) and np.array_equal(three, jthree)
    assert np.array_equal(bad < lengths, jbad < lengths)
    assert (three >= 0).any() and (three < 0).any()


@pytest.mark.parametrize("n", [1, 3])
def test_dryrun_multichip_on_cpu(n):
    entry.dryrun_multichip(n, device="cpu")


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
