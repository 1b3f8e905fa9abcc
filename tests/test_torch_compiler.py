"""The port's predicate lowering and group lowering against the JAX
package's: every builtin family's ``(allowed, rule)`` with the optimizer
on and off, on both schema buckets, and ``lower_group``'s verdicts and
member-evaluated masks on seeded member bits. Tolerance: exact equality."""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from policy_server_tpu.evaluation import groups as jax_groups
from policy_server_tpu.ops.codec import unpack_rows as jax_unpack_rows
from policy_server_tpu_torch.evaluation import groups as torch_groups
from policy_server_tpu_torch.ops.codec import unpack_rows

from torch_port_support import (
    catalog_docs,
    catalog_specs,
    jax_env,
    packed_batches,
    sync_envs,
    torch_env,
)

BATCH = 8


@pytest.fixture(scope="module", params=[True, False], ids=["opt", "noopt"])
def compiled_pair(request):
    docs = catalog_docs(2 * BATCH, seed=51)
    jenv = jax_env(catalog_specs(), predicate_opt=request.param)
    tenv = torch_env(catalog_specs(), predicate_opt=request.param)
    sync_envs(jenv, tenv, docs)
    return jenv, tenv, packed_batches(jenv, docs, BATCH)


@pytest.mark.parametrize("idx", [0, 1])
def test_each_family_matches_jax(compiled_pair, idx):
    """Every compiled policy, in the environment's order with one shared
    CSE table (as the fused program runs them), on identical features."""
    jenv, tenv, batches = compiled_pair
    wide = batches[idx]
    jlayout = jenv.schemas[idx].packed_layout()
    use_cse = jenv.optimization is not None
    assert (tenv.optimization is not None) == use_cse

    def jax_all(buf):
        feats = jax_unpack_rows(buf, jlayout, False, False)
        cse = {} if use_cse else None
        return {pid: fn(feats, cse) for pid, fn in jenv._compiled.items()}

    want = jax.jit(jax_all)(jnp.asarray(wide))
    feats = unpack_rows(
        torch.from_numpy(wide), tenv.schemas[idx].packed_layout(), False, False
    )
    cse = {} if use_cse else None
    assert list(tenv._compiled) == list(jenv._compiled)
    rejected = 0
    for pid, fn in tenv._compiled.items():
        allowed, rule = fn(feats, cse)
        w_allowed, w_rule = (np.asarray(x) for x in want[pid])
        assert allowed.dtype == torch.bool and rule.dtype == torch.int32
        np.testing.assert_array_equal(allowed.numpy(), w_allowed, err_msg=pid)
        np.testing.assert_array_equal(rule.numpy(), w_rule, err_msg=pid)
        rejected += int((~allowed).sum())
    assert rejected > 0


def test_scalar_inset_form_is_identical(compiled_pair):
    """The kernel's OR-chain InSet form and the table form agree."""
    _jenv, tenv, batches = compiled_pair
    feats = unpack_rows(
        torch.from_numpy(batches[0]), tenv.schemas[0].packed_layout(),
        False, False,
    )
    for pid, fn in tenv._compiled.items():
        a0, r0 = fn(feats, None, False)
        a1, r1 = fn(feats, None, True)
        assert torch.equal(a0, a1) and torch.equal(r0, r1), pid


EXPRESSIONS = [
    "signed() || (trusted() && not_latest())",
    "unprivileged() && (nonroot() || readonly())",
    "a() && !(b() || c())",
    "true || a()",
    "!a() && false",
    "a() || a() && b()",
    "!(a() && b()) || (c() && !a())",
]


@pytest.mark.parametrize("expression", EXPRESSIONS)
def test_lower_group_matches_jax(expression):
    names = sorted(
        jax_groups.referenced_members(jax_groups.parse_expression(expression))
    ) + ["unused"]
    jast = jax_groups.validate_expression(expression, set(names))
    tast = torch_groups.validate_expression(expression, set(names))
    bits = np.random.default_rng(zlib.crc32(expression.encode())).random(
        (64, len(names))
    ) < 0.5
    j_verdict, j_eval = jax_groups.lower_group(
        jast, {n: jnp.asarray(bits[:, i]) for i, n in enumerate(names)}
    )
    t_verdict, t_eval = torch_groups.lower_group(
        tast, {n: torch.from_numpy(bits[:, i]) for i, n in enumerate(names)}
    )
    np.testing.assert_array_equal(
        np.broadcast_to(t_verdict.numpy(), (64,)),
        np.broadcast_to(np.asarray(j_verdict), (64,)),
    )
    assert set(t_eval) == set(j_eval)
    for name in j_eval:
        np.testing.assert_array_equal(
            t_eval[name].numpy(), np.asarray(j_eval[name]), err_msg=name
        )
    # and both agree with the host evaluator row by row
    for row in range(8):
        verdict, evaluated = torch_groups.evaluate_group_host(
            tast, {n: bool(bits[row, i]) for i, n in enumerate(names)}
        )
        assert verdict == bool(np.broadcast_to(t_verdict.numpy(), (64,))[row])
        for name, mask in t_eval.items():
            assert bool(mask[row]) == evaluated.get(name, False)
