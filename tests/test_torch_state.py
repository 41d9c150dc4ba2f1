"""The encoder and decoder carries cross between the packages: x3tpu's
carry after k events, loaded into the port with ``carry_from_numpy``, runs
k more events in both, and every field of the two carries agrees (the
start of a lockstep diff between the engines)."""

import numpy as np

import jax.numpy as jnp

from x3tpu import codec as jcodec
from x3tpu_torch import codec

from test_torch_codec import (TINY_CAPS, TINY_CHUNK, TINY_PARAMS, _tiny_blocks,
                              jax_twin, plain_tiny)
from test_torch_codec import one_thread  # noqa: F401  (autouse)

# x3tpu's tiny-caps program (test_torch_codec runs the same one), so that
# one process compiles it once
CAPS, PARAMS, STEPS = jax_twin(TINY_CAPS), jax_twin(TINY_PARAMS), TINY_CHUNK


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

    carry = codec.enc_chunk(carry, TINY_PARAMS, STEPS)
    jcarry = jcodec._enc_chunk_jit(jcarry, PARAMS, STEPS)
    ours, ref = codec.carry_to_numpy(carry), codec.carry_to_numpy(jcarry)
    _assert_same(ours, ref, f"after {2 * STEPS} events")
    # the run got past the point where every context tier is in use
    assert ref["ctx1.promo_n"].any() and ref["d.n"].max() > 50


def test_dec_carry_round_trip_and_lockstep():
    """The decoder's carry on plain_tiny()'s streams: x3tpu's tiny-caps
    decode program (test_torch_decode runs the same one) for STEPS events,
    then both decoders for STEPS more."""
    words, byte_lens = plain_tiny()[:2]
    jcarry = jcodec._dec_init_jit(
        jnp.asarray(words.numpy().astype(np.uint32)),
        jnp.asarray(byte_lens.numpy().astype(np.int32)), PARAMS, CAPS)
    jcarry = jcodec._dec_chunk_jit(jcarry, PARAMS, STEPS)
    fields = codec.carry_to_numpy(jcarry)
    assert fields["src.words"].dtype == np.uint32
    assert fields["out"].dtype == np.uint8

    carry = codec.carry_from_numpy(fields)
    assert isinstance(carry, codec.DecCarry)
    _assert_same(codec.carry_to_numpy(carry), fields, "after loading")

    carry = codec.dec_chunk(carry, STEPS)
    jcarry = jcodec._dec_chunk_jit(jcarry, PARAMS, STEPS)
    ours, ref = codec.carry_to_numpy(carry), codec.carry_to_numpy(jcarry)
    _assert_same(ours, ref, f"after {2 * STEPS} events")
    # the run got past the first context promotions and some lanes' EOF
    assert ref["ctx1.promo_n"].any() and ref["done"].any()
