"""The port's codec against the JAX package's: ``unpack_rows`` in the wide,
transport and narrow transport16 forms on every schema bucket of the
builtin family catalog and of the flagship set, and the copied host half
(encode, stack, pack, to_transport, layouts) byte for byte. Tolerance:
exact equality (f32 lanes compare by their bits)."""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from policy_server_tpu.models import AdmissionReviewRequest
from policy_server_tpu.ops.codec import unpack_rows as jax_unpack_rows
from policy_server_tpu_torch.models import (
    AdmissionReviewRequest as TAdmissionReviewRequest,
)
from policy_server_tpu_torch.ops.codec import unpack_rows

from torch_port_support import (
    FORM_FLAGS,
    buffer_forms,
    catalog_docs,
    catalog_specs,
    export_state,
    firehose_docs,
    flagship_specs,
    jax_env,
    packed_batches,
    sync_envs,
    torch_env,
)

BATCH = 8


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for which, specs, docs in (
        ("catalog", catalog_specs(), catalog_docs(2 * BATCH, seed=41)),
        ("flagship", flagship_specs(), firehose_docs(2 * BATCH, seed=42)),
    ):
        jenv = jax_env(specs)
        tenv = torch_env(specs)
        sync_envs(jenv, tenv, docs)
        out[which] = (jenv, tenv, packed_batches(jenv, docs, BATCH))
    return out


def _as_comparable(arr: np.ndarray) -> np.ndarray:
    return arr.view(np.int32) if arr.dtype == np.float32 else arr


@pytest.mark.parametrize("which", ["catalog", "flagship"])
@pytest.mark.parametrize("form", ["wide", "transport", "narrow"])
def test_unpack_rows_matches_jax(pairs, which, form):
    jenv, tenv, batches = pairs[which]
    transport, narrow = FORM_FLAGS[form]
    for idx, wide in batches.items():
        buf = buffer_forms(jenv, idx, wide)[form]
        layout = tenv.schemas[idx].packed_layout()
        jlayout = jenv.schemas[idx].packed_layout()
        want = jax.jit(
            lambda b: jax_unpack_rows(b, jlayout, transport, narrow)
        )(jnp.asarray(buf))
        got = unpack_rows(torch.from_numpy(buf), layout, transport, narrow)
        assert set(got) == set(want)
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key].numpy()
            assert g.dtype == w.dtype, key
            assert g.shape == w.shape, key
            np.testing.assert_array_equal(
                _as_comparable(g), _as_comparable(w), err_msg=key
            )
        # not vacuous: some id lane and some presence bit is set
        assert any(np.asarray(v).any() for v in want.values())


@pytest.mark.parametrize("which", ["catalog", "flagship"])
def test_layouts_match_jax(pairs, which):
    jenv, tenv, _ = pairs[which]
    for js, ts in zip(jenv.schemas, tenv.schemas):
        assert dataclasses.asdict(ts.packed_layout()) == dataclasses.asdict(
            js.packed_layout()
        )
        assert list(ts.specs) == list(js.specs)


@pytest.mark.parametrize("which", ["catalog", "flagship"])
def test_host_encoding_is_byte_identical(pairs, which):
    """With the JAX table installed, the port's copied host half encodes
    new documents into the same wide, transport and narrow bytes."""
    jenv, tenv, _ = pairs[which]
    tenv.install_reference_state(*export_state(jenv))
    docs = firehose_docs(BATCH, seed=43, wide_every=2)
    for doc in docs:
        jp = AdmissionReviewRequest.from_dict(copy.deepcopy(doc)).request
        tp = TAdmissionReviewRequest.from_dict(copy.deepcopy(doc)).request
        ji, jenc = jenv.encode_bucketed(jp.to_dict())
        ti, tenc = tenv.encode_bucketed(tp.to_dict())
        assert ji == ti
        js, ts = jenv.schemas[ji], tenv.schemas[ti]
        jw = js.pack(js.stack([jenc], batch_size=2))
        tw = ts.pack(ts.stack([tenc], batch_size=2))
        np.testing.assert_array_equal(tw["__packed__"], jw["__packed__"])
        for vocab in (None, len(jenv.table)):
            np.testing.assert_array_equal(
                ts.to_transport(tw, vocab_size=vocab)["__packed__"],
                js.to_transport(jw, vocab_size=vocab)["__packed__"],
            )
    assert len(tenv.table) == len(jenv.table)


def test_install_rejects_a_different_layout(pairs):
    jenv, _tenv, _ = pairs["catalog"]
    other = torch_env({"priv": {"module": "builtin://pod-privileged"}})
    strings, layouts = export_state(jenv)
    with pytest.raises(ValueError):
        other.install_reference_state(strings, layouts)
