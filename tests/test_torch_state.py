"""The encoder carry crosses between the packages: x3tpu's carry after k
events, loaded into the port with ``carry_from_numpy``, runs m more events
in both, and every field of the two carries agrees (the start of a
lockstep diff between the engines)."""

import numpy as np

import jax.numpy as jnp

from x3tpu import codec as jcodec
from x3tpu_torch import codec

from test_torch_codec import TINY_CAPS, TINY_CHUNK, TINY_PARAMS, _tiny_blocks
from test_torch_codec import one_thread  # noqa: F401  (autouse)

# x3tpu's tiny-caps program (test_torch_codec runs the same one), so that
# one process compiles it once
CAPS, PARAMS, STEPS = TINY_CAPS, TINY_PARAMS, TINY_CHUNK


def _assert_same(a, b, when):
    assert a.keys() == b.keys(), when
    for key in a:
        if a[key].dtype == np.float32:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-3,
                                       err_msg=f"{key} {when}")
        else:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{key} {when}")


def test_carry_round_trip_and_lockstep():
    text, tlen = jcodec.pack_blocks(_tiny_blocks(), PARAMS, CAPS)
    jcarry = jcodec._enc_init_jit(jnp.asarray(text), jnp.asarray(tlen),
                                  PARAMS, CAPS)
    jcarry = jcodec._enc_chunk_jit(jcarry, PARAMS, STEPS)
    fields = codec.carry_to_numpy(jcarry)
    assert "ctx1.hub_pair" in fields and "ctx0.hub_pair" not in fields
    assert fields["sink.words"].dtype == np.uint32

    carry = codec.carry_from_numpy(fields)
    _assert_same(codec.carry_to_numpy(carry), fields, "after loading")

    carry = codec.enc_chunk(carry, PARAMS, STEPS)
    jcarry = jcodec._enc_chunk_jit(jcarry, PARAMS, STEPS)
    ours, ref = codec.carry_to_numpy(carry), codec.carry_to_numpy(jcarry)
    _assert_same(ours, ref, f"after {2 * STEPS} events")
    # the run got past the point where every context tier is in use
    assert ref["ctx1.promo_n"].any() and ref["d.n"].max() > 50
