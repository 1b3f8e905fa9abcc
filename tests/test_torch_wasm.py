"""The port's wasm engine against the JAX package's: the decoder, the
interpreter (control flow, traps, fuel, the wall-clock deadline), the
native core against the interpreter, the waPC, OPA/Gatekeeper and WASI
hosts on the WAT fixtures, and the waPC host capabilities with no context
service and no trust root.

Each case runs once per package (``side`` is the package's name) and
returns what it observed; the two observations must be equal, and the
port's must hold the case's own expectations. Inputs come from a seed
(the firehose documents); verdicts, messages and traps compare exactly."""

from __future__ import annotations

import copy
import importlib
import json
import os
import stat
import time

import pytest

from policy_server_tpu.policies.flagship import synthetic_firehose

import torch_wasm_fixtures as fixtures

JAX = "policy_server_tpu"
PORT = "policy_server_tpu_torch"


def mod(side: str, name: str):
    return importlib.import_module(f"{side}.{name}")


def instantiate(side: str, src: str, **kwargs):
    binary = mod(side, "wasm.binary")
    interp = mod(side, "wasm.interp")
    wat = mod(side, "wasm.wat")
    return interp.Instance(binary.decode_module(wat.assemble(src)), **kwargs)


def outcome(fn, *args):
    """A call's result, or its exception's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the observation is the raise
        return ("raise", type(e).__name__, str(e))


def both(case) -> object:
    """Run ``case`` through both packages; equal observations, or fail."""
    want = case(JAX)
    got = case(PORT)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the decoder and the interpreter (tests/test_wasm.py's cases)
# ---------------------------------------------------------------------------

ARITH_SRC = r"""
(module
  (func $fib (export "fib") (param $n i32) (result i32)
    local.get $n
    i32.const 2
    i32.lt_s
    if (result i32)
      local.get $n
    else
      local.get $n
      i32.const 1
      i32.sub
      call $fib
      local.get $n
      i32.const 2
      i32.sub
      call $fib
      i32.add
    end)
  (func (export "wrap") (result i32)
    i32.const 0x7fffffff
    i32.const 1
    i32.add)
  (func (export "sum_to") (param $n i32) (result i32)
    (local $i i32) (local $acc i32)
    block $done
      loop $next
        local.get $i
        local.get $n
        i32.ge_s
        br_if $done
        local.get $acc
        local.get $i
        i32.add
        local.set $acc
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        br $next
      end
    end
    local.get $acc)
)"""

MEMORY_SRC = r"""
(module
  (memory (export "memory") 1)
  (data (i32.const 8) "wasm")
  (func (export "peek") (param $p i32) (result i32)
    local.get $p
    i32.load8_u)
  (func (export "oob") (result i32)
    i32.const 70000
    i32.load)
  (func (export "div0") (result i32)
    i32.const 1
    i32.const 0
    i32.div_s)
  (func (export "boom")
    unreachable)
)"""

SPIN_SRC = r"""
(module
  (func (export "spin")
    loop $forever
      br $forever
    end)
)"""

SPIN_CALLS_SRC = r"""
(module
  (func $burn (result i32)
    (local $i i32)
    block $done
      loop $next
        local.get $i
        i32.const 200
        i32.ge_s
        br_if $done
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        br $next
      end
    end
    local.get $i)
  (func (export "spin_calls")
    loop $forever
      call $burn
      drop
      br $forever
    end)
)"""

FILL_SRC = r"""
(module
  (memory (export "memory") 1)
  (func (export "fill_huge")
    i32.const 0
    i32.const 65
    i32.const -1
    memory.fill)
)"""

BR_TABLE_SRC = r"""
(module
  (global $acc (mut i32) (i32.const 0))
  (func (export "pick") (param $i i32) (result i32)
    block $c
      block $b
        block $a
          local.get $i
          br_table $a $b $c
        end
        i32.const 10
        return
      end
      i32.const 20
      return
    end
    i32.const 30)
  (func (export "bump") (result i32)
    global.get $acc
    i32.const 1
    i32.add
    global.set $acc
    global.get $acc)
)"""


def case_arith(side):
    inst = instantiate(side, ARITH_SRC)
    return [inst.invoke("fib", 10), inst.invoke("wrap"), inst.invoke("sum_to", 100)]


def case_memory(side):
    inst = instantiate(side, MEMORY_SRC)
    return [outcome(inst.invoke, n, *a) for n, a in
            (("peek", (8,)), ("oob", ()), ("div0", ()), ("boom", ()))]


def case_fuel(side):
    return outcome(instantiate(side, SPIN_SRC, fuel=10_000).invoke, "spin")


def case_fuel_not_refunded(side):
    inst = instantiate(side, SPIN_CALLS_SRC, fuel=100_000)
    return outcome(inst.invoke, "spin_calls")


def case_bulk_memory(side):
    return outcome(instantiate(side, FILL_SRC).invoke, "fill_huge")


def case_br_table_globals(side):
    inst = instantiate(side, BR_TABLE_SRC)
    return [inst.invoke("pick", i)[0] for i in (0, 1, 2, 9)] + [
        inst.invoke("bump"), inst.invoke("bump"),
    ]


def case_flatten(side):
    wapc = mod(side, "wasm.wapc")
    doc = {"b": [1, {"x": True}], "a": None, "s": "txt", "a.#0.b": 2, "%": ""}
    return [
        wapc.flatten_payload(doc),
        outcome(wapc.flatten_payload, {"image": "x\x00request.evil\x00true"}),
    ]


def case_dotted_key(side):
    oracle = mod(side, "policies.wasm_oracle")
    policy = oracle.oracle_policy("host-namespaces")
    return [
        policy.validate({"object": {"spec.hostNetwork": True}}, {}),
        policy.validate({"object": {"spec": {"hostNetwork": True}}}, {}),
    ]


def case_missing_export(side):
    wapc = mod(side, "wasm.wapc")
    wat = mod(side, "wasm.wat")
    return outcome(wapc.WapcGuest, wat.assemble('(module (memory (export "memory") 1))'))


def case_decode(side):
    """The decoded shape of every fixture module."""
    binary = mod(side, "wasm.binary")
    out = []
    for data in (
        fixtures.wasi_policy_wasm(),
        fixtures.builtin_oracle_wasm(),
        fixtures.wapc_privileged_wasm(),
    ):
        m = binary.decode_module(data)
        out.append((
            sorted((e.name, e.kind) for e in m.exports),
            [(i.module, i.name, i.kind) for i in m.imports],
            len(m.functions), len(m.code), len(m.types),
            [(list(t.params), list(t.results)) for t in m.types],
        ))
    return out


def case_fuel_deadline_message(side):
    wasm_policy = mod(side, "evaluation.wasm_policy")
    wat = mod(side, "wasm.wat")
    spin = wat.assemble(r"""
    (module
      (import "wapc" "__guest_request" (func $gr (param i32 i32)))
      (import "wapc" "__guest_response" (func $resp (param i32 i32)))
      (memory (export "memory") 1)
      (global $flat (mut i32) (i32.const 1))
      (export "__flat_abi" (global $flat))
      (func (export "__guest_call") (param i32 i32) (result i32)
        loop $forever
          br $forever
        end
        i32.const 1)
    )""")
    module = wasm_policy.WasmPolicyModule(spin, name="spin", digest="x", fuel=100_000)
    return module.build({}).host_evaluator({"uid": "u"})


INTERP_CASES = {
    "arith": (case_arith, lambda r: r == [[55], [-0x80000000], [4950]]),
    "memory": (case_memory, lambda r: r[0] == ("ok", [ord("w")])
               and "out of bounds" in r[1][2] and "divide by zero" in r[2][2]
               and "unreachable" in r[3][2]),
    "fuel": (case_fuel, lambda r: r[1] == "WasmFuelExhausted"),
    "fuel_not_refunded": (case_fuel_not_refunded,
                          lambda r: r[1] == "WasmFuelExhausted"),
    "bulk_memory": (case_bulk_memory, lambda r: "out of bounds" in r[2]),
    "br_table_globals": (case_br_table_globals,
                         lambda r: r == [10, 20, 30, 30, [1], [2]]),
    "flatten": (case_flatten, lambda r: r[0].startswith(b"%25\x00s\x00")
                and r[1][1] == "WapcError" and "NUL" in r[1][2]),
    "dotted_key": (case_dotted_key, lambda r: r[0]["accepted"] is True
                   and r[1]["accepted"] is False),
    "missing_export": (case_missing_export, lambda r: "__guest_call" in r[2]),
    "decode": (case_decode, lambda r: len(r) == 3),
    "fuel_deadline_message": (
        case_fuel_deadline_message,
        lambda r: r["accepted"] is False
        and r["message"] == "execution deadline exceeded",
    ),
}


@pytest.mark.parametrize("name", sorted(INTERP_CASES))
def test_interpreter_case_matches_jax(name, monkeypatch):
    """Each tests/test_wasm.py case on the interpreter, both packages."""
    monkeypatch.setenv("PSTPU_NO_NATIVE_WASM", "1")
    case, expect = INTERP_CASES[name]
    assert expect(both(case))


@pytest.mark.parametrize("name", ["dotted_key", "fuel_deadline_message"])
def test_native_core_case_matches_interpreter(name, monkeypatch):
    """The cases whose hosts build their instances through
    ``make_instance``, on the port's native core: equal to the port's
    interpreter (the native core against the interpreters on modules
    built directly is ``test_native_core_matches_interpreters``)."""
    monkeypatch.setenv("PSTPU_NO_NATIVE_WASM", "1")
    case, expect = INTERP_CASES[name]
    interp_obs = case(PORT)
    monkeypatch.delenv("PSTPU_NO_NATIVE_WASM")
    native_obs = case(PORT)
    assert native_obs == interp_obs
    assert expect(native_obs)


# ---------------------------------------------------------------------------
# the wall-clock deadline (tests/test_wasm_deadline.py's cases)
# ---------------------------------------------------------------------------


def test_interpreter_deadline_cuts_spin_loop():
    for side in (JAX, PORT):
        interp = mod(side, "wasm.interp")
        binary = mod(side, "wasm.binary")
        wat = mod(side, "wasm.wat")
        with interp.deadline_scope(0.2):
            inst = interp.Instance(
                binary.decode_module(wat.assemble(fixtures.SPIN_WAPC)), fuel=None
            )
            t0 = time.perf_counter()
            with pytest.raises(interp.WasmDeadlineExceeded):
                inst.invoke("__guest_call", 0, 0)
            elapsed = time.perf_counter() - t0
        assert 0.1 < elapsed < 2.0, side


@pytest.mark.parametrize("engine", ["interp", "native"])
def test_no_deadline_without_scope(engine, monkeypatch):
    """Outside a scope the fuel limit still ends a runaway guest."""
    if engine == "interp":
        monkeypatch.setenv("PSTPU_NO_NATIVE_WASM", "1")
    native_exec = mod(PORT, "wasm.native_exec")
    binary = mod(PORT, "wasm.binary")
    wat = mod(PORT, "wasm.wat")
    before = native_exec.engine_counts()[engine]
    inst = native_exec.make_instance(
        binary.decode_module(wat.assemble(fixtures.SPIN_WAPC)), None, fuel=100_000
    )
    assert native_exec.engine_counts()[engine] == before + 1
    got = outcome(inst.invoke, "__guest_call", 0, 0)
    want = outcome(
        mod(JAX, "wasm.interp").Instance(
            mod(JAX, "wasm.binary").decode_module(fixtures_jax_spin()), fuel=100_000
        ).invoke, "__guest_call", 0, 0,
    )
    assert got[:2] == want[:2] == ("raise", "WasmFuelExhausted")


def fixtures_jax_spin() -> bytes:
    return mod(JAX, "wasm.wat").assemble(fixtures.SPIN_WAPC)


@pytest.mark.parametrize("engine", ["interp", "native"])
def test_wasm_policy_rejected_in_band_at_wall_clock(engine, monkeypatch):
    if engine == "interp":
        monkeypatch.setenv("PSTPU_NO_NATIVE_WASM", "1")
    out = []
    for side in (JAX, PORT):
        wasm_policy = mod(side, "evaluation.wasm_policy")
        module = wasm_policy.WasmPolicyModule(
            mod(side, "wasm.wat").assemble(fixtures.SPIN_WAPC),
            name="spin", digest="x", fuel=None, wall_clock_budget=0.3,
        )
        program = module.build({})
        t0 = time.perf_counter()
        out.append(program.host_evaluator({"uid": "u1"}))
        assert time.perf_counter() - t0 < 2.0
    assert out[0] == out[1] == {
        "accepted": False, "message": "execution deadline exceeded", "code": 500,
    }


def test_settings_validation_deadline_cut():
    out = []
    for side in (JAX, PORT):
        wasm_policy = mod(side, "evaluation.wasm_policy")
        module = wasm_policy.WasmPolicyModule(
            mod(side, "wasm.wat").assemble(fixtures.SPIN_WAPC),
            name="spin", digest="x", fuel=None, wall_clock_budget=0.3,
        )
        t0 = time.perf_counter()
        resp = module.validate_settings({})
        assert time.perf_counter() - t0 < 2.0
        out.append((resp.valid, resp.message))
    assert out[0] == out[1]
    assert out[1][0] is False and "execution deadline exceeded" in out[1][1]


def test_wasm_policy_serves_deadline_through_environment():
    """The builder sets the budget on the module, and a spinning validate
    is answered in-band, through each package's environment."""
    from torch_port_support import jax_env, pod_review, torch_env

    out = []
    for side, build in ((JAX, jax_env), (PORT, torch_env)):
        module = mod(side, "evaluation.wasm_policy").WasmPolicyModule(
            mod(side, "wasm.wat").assemble(fixtures.SPIN_ON_VALIDATE_WAPC),
            name="spin", digest="x", fuel=None,
        )
        env = build(
            {"spin": {"module": "file:///s.wasm"}}, backend="oracle",
            module_resolver=lambda url, m=module: m,
            wasm_wall_clock_budget=0.3,
        )
        assert module.wall_clock_budget == 0.3
        t0 = time.perf_counter()
        resp = env.validate("spin", pod_review(side_of(side), namespace="default", privileged=False))
        assert time.perf_counter() - t0 < 2.0
        out.append(resp.to_dict())
    assert out[0] == out[1]
    assert out[1]["allowed"] is False and out[1]["status"]["code"] == 500
    assert "execution deadline exceeded" in out[1]["status"]["message"]


def side_of(side: str):
    from torch_port_support import audit_sides

    jax_side, port_side = audit_sides()
    return jax_side if side == JAX else port_side


# ---------------------------------------------------------------------------
# the native core against the interpreter (tests/test_native_wasm.py)
# ---------------------------------------------------------------------------

NATIVE_ARITH = """
(module
  (memory (export "memory") 1)
  (func (export "mix") (param $a i32) (param $b i64) (result i64)
    local.get $a
    i32.const 7
    i32.mul
    i32.const 13
    i32.rem_s
    i64.extend_i32_s
    local.get $b
    i64.const 3
    i64.shl
    i64.xor
    i64.const 1000003
    i64.rem_u)
  (func (export "loopy") (param $n i32) (result i32)
    (local $i i32) (local $acc i32)
    block $done
      loop $go
        local.get $i
        local.get $n
        i32.ge_u
        br_if $done
        local.get $acc
        local.get $i
        i32.add
        i32.const 2654435761
        i32.mul
        local.set $acc
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        br $go
      end
    end
    local.get $acc)
  (func (export "memrw") (param $addr i32) (param $v i32) (result i32)
    local.get $addr
    local.get $v
    i32.store
    local.get $addr
    i32.load8_u)
)
"""

NATIVE_TRAPS = """
(module
  (memory (export "memory") 1)
  (func (export "div") (param i32) (param i32) (result i32)
    local.get 0
    local.get 1
    i32.div_s)
  (func (export "oob") (result i32)
    i32.const 100000000
    i32.load)
)
"""

NATIVE_HOST = """
(module
  (import "env" "add3" (func $add3 (param i32 i32 i32) (result i32)))
  (import "env" "poke" (func $poke (param i32)))
  (memory (export "memory") 1)
  (func (export "run") (param i32) (result i32)
    local.get 0
    call $poke
    i32.const 10
    i32.const 20
    local.get 0
    call $add3)
)
"""

NATIVE_GLOBAL = """
(module
  (memory (export "memory") 1)
  (global $g (mut i32) (i32.const 41))
  (export "g" (global $g))
  (func (export "bump") (result i32)
    global.get $g
    i32.const 1
    i32.add
    global.set $g
    global.get $g)
)
"""


def engines(src: str, imports=None, fuel=500_000_000):
    """(JAX interpreter, port interpreter, port native core) on one
    module."""
    j = mod(JAX, "wasm.interp").Instance(
        mod(JAX, "wasm.binary").decode_module(mod(JAX, "wasm.wat").assemble(src)),
        imports, fuel=fuel,
    )
    m = mod(PORT, "wasm.binary").decode_module(mod(PORT, "wasm.wat").assemble(src))
    native_exec = mod(PORT, "wasm.native_exec")
    return (
        j,
        mod(PORT, "wasm.interp").Instance(m, imports, fuel=fuel),
        native_exec.NativeInstance(m, imports, fuel=fuel),
    )


def native_arith(insts):
    out = []
    for inst in insts:
        obs = [inst.invoke("mix", a, b)
               for a in (-5, 0, 1, 123456789, -2147483648, 2147483647)
               for b in (0, -1, 9223372036854775807, -9223372036854775808, 42)]
        obs += [inst.invoke("loopy", n) for n in (0, 1, 7, 100, 10000)]
        obs.append(inst.invoke("memrw", 1024, 0x11223344))
        obs.append(inst.memory.read(1024, 4))
        out.append(obs)
    return out


def native_traps(insts):
    return [
        [outcome(inst.invoke, "div", *a) for a in ((7, -2), (1, 0), (-2147483648, -1))]
        + [outcome(inst.invoke, "oob")[:2]]
        for inst in insts
    ]


def native_fuel(insts):
    return [outcome(inst.invoke, "spin")[:2] for inst in insts]


def native_host(insts_factory):
    out = []
    for make in insts_factory:
        calls = []

        def add3(inst, a, b, c):
            calls.append((a, b, c))
            return a + b + c

        def poke(inst, addr):
            inst.memory.write(addr, b"\xaa\xbb")

        inst = make({"env": {"add3": add3, "poke": poke}})
        out.append((inst.invoke("run", 3), calls, inst.memory.read(3, 2)))
    return out


def native_globals(insts):
    return [(inst.invoke("bump"), inst.global_value("g")) for inst in insts]


@pytest.mark.parametrize("name", ["arith", "traps", "fuel", "host", "globals"])
def test_native_core_matches_interpreters(name):
    """The port's native core, the port's interpreter and the JAX
    package's interpreter on the same modules: equal results, traps,
    fuel exhaustion, host calls and memory effects."""
    if name == "arith":
        obs = native_arith(engines(NATIVE_ARITH))
    elif name == "traps":
        obs = native_traps(engines(NATIVE_TRAPS))
        assert obs[2][1][1] == "WasmTrap" and obs[2][3] == ("raise", "WasmTrap")
    elif name == "fuel":
        obs = native_fuel(engines(SPIN_SRC, fuel=10_000))
        assert obs[2] == ("raise", "WasmFuelExhausted")
    elif name == "host":
        def factory(k):
            return lambda imports: engines(NATIVE_HOST, imports)[k]

        obs = native_host([factory(0), factory(1), factory(2)])
        assert obs[2] == ([33], [(10, 20, 3)], b"\xaa\xbb")
    else:
        obs = native_globals(engines(NATIVE_GLOBAL))
        assert obs[2] == ([42], 42)
    assert obs[0] == obs[1] == obs[2]


def test_host_exception_propagates_natively():
    class Custom(Exception):
        pass

    def boom(inst):
        raise Custom("kaboom")

    src = """
(module
  (import "env" "boom" (func $boom))
  (memory (export "memory") 1)
  (func (export "run")
    call $boom)
)
"""
    inst = engines(src, {"env": {"boom": boom}})[2]
    with pytest.raises(Custom, match="kaboom"):
        inst.invoke("run")


def test_make_instance_prefers_native_and_counts(monkeypatch):
    native_exec = mod(PORT, "wasm.native_exec")
    m = mod(PORT, "wasm.binary").decode_module(
        mod(PORT, "wasm.wat").assemble(NATIVE_ARITH)
    )
    before = native_exec.engine_counts()
    assert isinstance(native_exec.make_instance(m, None), native_exec.NativeInstance)
    monkeypatch.setenv("PSTPU_NO_NATIVE_WASM", "1")
    inst = native_exec.make_instance(m, None)
    assert type(inst) is mod(PORT, "wasm.interp").Instance
    after = native_exec.engine_counts()
    assert after["native"] == before["native"] + 1
    assert after["interp"] == before["interp"] + 1


def test_unsupported_module_goes_to_the_interpreter():
    """A function type of more than 32 parameters is outside the native
    core's model (``NativeUnsupported``): make_instance serves the module
    with the interpreter and counts it there; this is not a build
    failure."""
    native_exec = mod(PORT, "wasm.native_exec")
    params = " ".join(["i32"] * 33)
    src = f"""
(module
  (func $wide (param {params}) (result i32)
    local.get 32)
  (func (export "get") (result i32)
    {" ".join(["i32.const 1"] * 32)}
    i32.const 7
    call $wide)
)
"""
    m = mod(PORT, "wasm.binary").decode_module(mod(PORT, "wasm.wat").assemble(src))
    with pytest.raises(native_exec.NativeUnsupported):
        native_exec.NativeInstance(m, None)
    before = native_exec.engine_counts()
    inst = native_exec.make_instance(m, None)
    assert type(inst) is mod(PORT, "wasm.interp").Instance
    assert inst.invoke("get") == [7]
    assert native_exec.engine_counts()["interp"] == before["interp"] + 1
    assert native_exec.engine_counts()["native"] == before["native"]


def _broken_source(tmp_path, monkeypatch):
    src = tmp_path / "wasmint.cpp"
    src.write_text("this is not C++ {\n")
    monkeypatch.setattr(mod(PORT, "wasm.native_exec"), "SOURCE", src)


def _failing_gxx(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text("#!/bin/sh\necho 'g++: refused' >&2\nexit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")


@pytest.mark.parametrize("fault", [_broken_source, _failing_gxx])
def test_failed_native_build_raises_and_makes_no_interpreter(
    fault, tmp_path, monkeypatch
):
    """A failed g++ build of the native core raises with g++'s text; no
    instance is made, the interpreter's least of all."""
    native_exec = mod(PORT, "wasm.native_exec")
    buildcache = mod(PORT, "ops.buildcache")
    monkeypatch.delenv("PSTPU_NO_NATIVE_WASM", raising=False)
    monkeypatch.setattr(buildcache, "_build_dir", tmp_path / "build")
    monkeypatch.setattr(native_exec, "_lib", None)
    fault(tmp_path, monkeypatch)
    m = mod(PORT, "wasm.binary").decode_module(
        mod(PORT, "wasm.wat").assemble(NATIVE_ARITH)
    )
    before = native_exec.engine_counts()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_exec.make_instance(m, None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        mod(PORT, "wasm.wapc").KubewardenWapcPolicy(
            fixtures.wapc_privileged_wasm()
        ).validate({"object": {}}, {})
    assert native_exec.engine_counts() == before


def test_failed_native_load_raises(tmp_path, monkeypatch):
    """A library that does not load (here: not an ELF file, newer than
    the source so no build runs) raises rather than falling back."""
    native_exec = mod(PORT, "wasm.native_exec")
    buildcache = mod(PORT, "ops.buildcache")
    monkeypatch.delenv("PSTPU_NO_NATIVE_WASM", raising=False)
    monkeypatch.setattr(buildcache, "_build_dir", tmp_path)
    monkeypatch.setattr(native_exec, "_lib", None)
    native_exec.library_path().write_bytes(b"not a shared object")
    with pytest.raises(RuntimeError, match="failed to load"):
        native_exec.build_library()


# ---------------------------------------------------------------------------
# the ABI hosts on the fixtures, over seeded firehose payloads
# ---------------------------------------------------------------------------


def firehose_requests(n: int, seed: int) -> list[dict]:
    return [
        copy.deepcopy(d["request"]) for d in synthetic_firehose(n, seed=seed)
    ]


def host_verdicts(side: str, abi: str, requests: list[dict]) -> list:
    if abi == "wapc":
        policy = mod(side, "wasm.wapc").KubewardenWapcPolicy(
            fixtures.wapc_privileged_wasm()
        )
        return [policy.validate(r, {}) for r in requests] + [
            policy.validate_settings({})
        ]
    if abi == "opa":
        opa = mod(side, "wasm.opa")
        policy = opa.OpaPolicy(fixtures.builtin_oracle_wasm())
        return [opa.gatekeeper_validate(policy, r) for r in requests] + [
            policy.builtins()
        ]
    policy = mod(side, "wasm.wasi").WasiPolicy(fixtures.wasi_policy_wasm())
    return [policy.validate(r, {}) for r in requests] + [
        policy.validate_settings({"anything": 1})
    ]


@pytest.mark.parametrize("abi", ["wapc", "opa", "wasi"])
def test_abi_hosts_match_jax_on_both_engines(abi, monkeypatch):
    """waPC, OPA/Gatekeeper and WASI: the port's verdicts on its native
    core and on its interpreter equal the JAX package's, and the engine
    counts say which engine served."""
    native_exec = mod(PORT, "wasm.native_exec")
    requests = firehose_requests(24, seed=41)
    want = host_verdicts(JAX, abi, requests)
    before = native_exec.engine_counts()
    native = host_verdicts(PORT, abi, requests)
    mid = native_exec.engine_counts()
    monkeypatch.setenv("PSTPU_NO_NATIVE_WASM", "1")
    interp = host_verdicts(PORT, abi, requests)
    after = native_exec.engine_counts()
    assert native == want
    assert interp == want
    assert mid["native"] > before["native"] and mid["interp"] == before["interp"]
    assert after["interp"] > mid["interp"] and after["native"] == mid["native"]
    # the batch is not vacuous: some request is rejected, some accepted
    verdicts = [v[0] if isinstance(v, tuple) else v.get("accepted") for v in want[:-1]]
    assert True in verdicts and False in verdicts


# ---------------------------------------------------------------------------
# the host capabilities (tests/test_capabilities.py), no context service
# ---------------------------------------------------------------------------


def payload_with_context(side: str) -> dict:
    key = mod(side, "context" if side == PORT else "context.service").CONTEXT_KEY
    return {
        "namespace": "default",
        key: {
            "v1/Namespace": [
                {"metadata": {"name": "default", "labels": {"env": "prod"}}},
                {"metadata": {"name": "dev", "labels": {"env": "dev"}}},
            ],
            "v1/Service": [
                {"metadata": {"name": "api", "namespace": "default"}},
                {"metadata": {"name": "api", "namespace": "other"}},
            ],
        },
    }


def call(caps, ns, op, doc):
    return json.loads(caps[(ns, op)](json.dumps(doc).encode()))


def cap_kubernetes(side):
    caps = mod(side, "wasm.capabilities").build_default_capabilities(
        payload_with_context(side)
    )
    lookups = [
        ("list_all_resources", {"api_version": "v1", "kind": "Namespace"}),
        ("list_all_resources", {"api_version": "v1", "kind": "Namespace",
                                "label_selector": "env=prod"}),
        ("list_resources_by_namespace", {"api_version": "v1", "kind": "Service",
                                         "namespace": "default"}),
        ("get_resource", {"api_version": "v1", "kind": "Service",
                          "name": "api", "namespace": "other"}),
        ("get_resource", {"api_version": "v1", "kind": "Secret", "name": "x",
                          "namespace": "default"}),
        ("list_all_resources", {"api_version": "v1", "kind": "Secret"}),
    ]
    return [outcome(call, caps, "kubernetes", op, doc) for op, doc in lookups]


def cap_network(side):
    caps_mod = mod(side, "wasm.capabilities")
    caps = caps_mod.build_default_capabilities({})
    opted = caps_mod.build_default_capabilities({}, allow_network=True)
    return [
        outcome(call, caps, "net", "v1/dns_lookup_host", {"host": "example.com"}),
        outcome(call, caps, "oci", "v1/manifest_digest", {"image": "x"}),
        outcome(call, opted, "oci", "v1/manifest_digest", {"image": "x"}),
    ]


def cap_sigstore(side, tmp_path):
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat, PublicFormat,
    )

    images = mod(side, "policies.images")
    key = Ed25519PrivateKey.from_private_bytes(bytes(range(32)))
    priv = key.private_bytes(Encoding.PEM, PrivateFormat.PKCS8, NoEncryption())
    pub = key.public_key().public_bytes(
        Encoding.PEM, PublicFormat.SubjectPublicKeyInfo
    ).decode()
    image = "reg.example/signed:1"
    store = tmp_path / side
    store.mkdir()
    images.write_signature_bundle(str(store), image, images.sign_image(priv, image))
    caps = mod(side, "wasm.capabilities").build_default_capabilities(
        {}, signature_bundle_source=images.file_bundle_source(str(store))
    )
    return [
        outcome(call, caps, "kubewarden", "v1/verify", {"image": image, "pub_keys": [pub]}),
        outcome(call, caps, "kubewarden", "v1/verify",
                {"image": "reg.example/unsigned:1", "pub_keys": [pub]}),
        outcome(call, caps, "kubewarden", "v2/verify", {"image": image}),
    ]


def cap_certificate(side):
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import Encoding
    from cryptography.x509.oid import NameOID

    def make_cert(subject, issuer_name, issuer_key, key, ca=False):
        now = datetime.datetime.now(datetime.timezone.utc)
        return (
            x509.CertificateBuilder()
            .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, subject)]))
            .issuer_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, issuer_name)]))
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.BasicConstraints(ca=ca, path_length=None), critical=True)
            .sign(issuer_key, hashes.SHA256())
        )

    ca_key = ec.generate_private_key(ec.SECP256R1())
    leaf_key = ec.generate_private_key(ec.SECP256R1())
    other_key = ec.generate_private_key(ec.SECP256R1())
    ca = make_cert("ca", "ca", ca_key, ca_key, ca=True)
    leaf = make_cert("leaf", "ca", ca_key, leaf_key)
    other = make_cert("other", "other", other_key, other_key, ca=True)

    def pem_doc(cert):
        return {"encoding": "Pem", "data": list(cert.public_bytes(Encoding.PEM))}

    caps = mod(side, "wasm.capabilities").build_default_capabilities({})
    return [
        call(caps, "crypto", "v1/is_certificate_trusted",
             {"cert": pem_doc(leaf), "cert_chain": [pem_doc(c)]})
        for c in (ca, other)
    ]


HOST_CALL_REQ = '{"api_version":"v1","kind":"Namespace"}'
HOST_CALL_SRC = f"""
(module
  (import "wapc" "__guest_request" (func $greq (param i32 i32)))
  (import "wapc" "__guest_response" (func $gresp (param i32 i32)))
  (import "wapc" "__host_call"
    (func $hcall (param i32 i32 i32 i32 i32 i32 i32 i32) (result i32)))
  (memory (export "memory") 2)
  (data (i32.const 8) "kubernetes")
  (data (i32.const 32) "list_all_resources")
  (data (i32.const 64) "{HOST_CALL_REQ.replace('"', chr(92) + chr(34))}")
  (data (i32.const 192) "{{\\"accepted\\":true}}")
  (data (i32.const 224) "{{\\"accepted\\":false}}")
  (global $flat (mut i32) (i32.const 1))
  (export "__flat_abi" (global $flat))
  (func (export "__guest_call") (param $op_len i32) (param $plen i32) (result i32)
    i32.const 4096
    i32.const 8192
    call $greq
    i32.const 0
    i32.const 0
    i32.const 8
    i32.const 10
    i32.const 32
    i32.const 18
    i32.const 64
    i32.const {len(HOST_CALL_REQ)}
    call $hcall
    if
      i32.const 192
      i32.const 17
      call $gresp
    else
      i32.const 224
      i32.const 18
      call $gresp
    end
    i32.const 1)
)
"""


def cap_host_call(side):
    wapc = mod(side, "wasm.wapc")
    guest = wapc.WapcGuest(mod(side, "wasm.wat").assemble(HOST_CALL_SRC))
    caps = mod(side, "wasm.capabilities").build_default_capabilities(
        payload_with_context(side)
    )
    return [
        json.loads(guest.call("validate", wapc.flatten_payload({}), caps)),
        json.loads(guest.call("validate", wapc.flatten_payload({}))),
    ]


KEYLESS_SRC = """
(module
  (import "wapc" "__guest_request" (func $greq (param i32 i32)))
  (import "wapc" "__guest_response" (func $gresp (param i32 i32)))
  (import "wapc" "__guest_error" (func $gerr (param i32 i32)))
  (import "wapc" "__host_call"
    (func $hcall (param i32 i32 i32 i32 i32 i32 i32 i32) (result i32)))
  (import "wapc" "__host_error_len" (func $herrlen (result i32)))
  (import "wapc" "__host_error" (func $herr (param i32)))
  (memory (export "memory") 2)
  (data (i32.const 8) "kubewarden")
  (data (i32.const 32) "v2/verify")
  (data (i32.const 64) "{}")
  (data (i32.const 192) "{\\22accepted\\22:true}")
  (data (i32.const 256) "{\\22valid\\22:true}")
  (global $flat (mut i32) (i32.const 1))
  (export "__flat_abi" (global $flat))
  (func (export "__guest_call") (param $op_len i32) (param $plen i32) (result i32)
    i32.const 4096
    i32.const 8192
    call $greq
    local.get $op_len
    i32.const 8
    i32.ne
    if
      i32.const 256
      i32.const 14
      call $gresp
      i32.const 1
      return
    end
    i32.const 0
    i32.const 0
    i32.const 8
    i32.const 10
    i32.const 32
    i32.const 9
    i32.const 64
    i32.const 2
    call $hcall
    if
      i32.const 192
      i32.const 17
      call $gresp
      i32.const 1
      return
    end
    i32.const 1024
    call $herr
    i32.const 1024
    call $herrlen
    call $gerr
    i32.const 0)
)
"""


def cap_keyless_through_environment(side):
    """The guest asks for kubewarden/v2/verify; with no trust root the
    host raises before reaching the keyless verifier, and the guest
    answers that error in-band."""
    from torch_port_support import jax_env, pod_review, torch_env

    module = mod(side, "evaluation.wasm_policy").WasmPolicyModule(
        mod(side, "wasm.wat").assemble(KEYLESS_SRC), name="keyless", digest="x"
    )
    build = jax_env if side == JAX else torch_env
    env = build({"keyless": {"module": "file:///k.wasm"}}, backend="oracle",
                module_resolver=lambda url: module)
    return env.validate("keyless", pod_review(side_of(side), namespace="default", privileged=False)).to_dict()


CAP_CASES = {
    "kubernetes": (cap_kubernetes, lambda r: r[0][1]["items"][1]["metadata"]["name"] == "dev"
                   and "allowlist" in r[4][2] and r[5][1]["items"] == []),
    "network": (cap_network, lambda r: "allowNetworkCapabilities" in r[0][2]
                and "allowNetworkCapabilities" in r[1][2] and "egress" in r[2][2]),
    "sigstore": (cap_sigstore, lambda r: r[0][1]["is_trusted"] is True
                 and r[1][1]["is_trusted"] is False and "keyless" in r[2][2]),
    "certificate": (cap_certificate, lambda r: r[0]["trusted"] is True
                    and r[1]["trusted"] is False),
    "host_call": (cap_host_call, lambda r: r == [{"accepted": True}, {"accepted": False}]),
    "keyless_no_trust_root": (
        cap_keyless_through_environment,
        lambda r: r["allowed"] is False and r["status"]["code"] == 500
        and "Fulcio/Rekor" in r["status"]["message"],
    ),
}


@pytest.mark.parametrize("name", sorted(CAP_CASES))
def test_capability_case_matches_jax(name, tmp_path):
    case, expect = CAP_CASES[name]
    if name == "sigstore":
        got = both(lambda side: cap_sigstore(side, tmp_path))
    else:
        got = both(case)
    assert expect(got)


# ---------------------------------------------------------------------------
# the port's fixture copies against the JAX test suite's fixtures
# ---------------------------------------------------------------------------


def _jax_fixture(name: str):
    if name == "wasi":
        import wasi_fixture

        return wasi_fixture.wasi_policy_wasm()
    if name == "opa_builtins":
        import opa_builtin_fixture

        return opa_builtin_fixture.builtin_oracle_wasm()
    if name == "wapc_privileged":
        return mod(JAX, "policies.wasm_oracle").oracle_wasm("pod-privileged")
    import test_wasm_deadline

    return getattr(test_wasm_deadline, name)


FIXTURE_COPIES = {
    "wasi": fixtures.wasi_policy_wasm,
    "opa_builtins": fixtures.builtin_oracle_wasm,
    "wapc_privileged": fixtures.wapc_privileged_wasm,
    "SPIN_WAPC": lambda: fixtures.SPIN_WAPC,
    "SPIN_ON_VALIDATE_WAPC": lambda: fixtures.SPIN_ON_VALIDATE_WAPC,
}


@pytest.mark.parametrize("name", sorted(FIXTURE_COPIES))
def test_fixture_copy_equals_jax_fixture(name):
    """Each fixture in ``torch_wasm_fixtures`` is byte-equal to the one
    the JAX package's tests use; a spin loop's WAT text is equal too, and
    both packages' assemblers make the same bytes of it."""
    got = FIXTURE_COPIES[name]()
    want = _jax_fixture(name)
    assert got == want
    if isinstance(got, str):
        assert mod(PORT, "wasm.wat").assemble(got) == mod(JAX, "wasm.wat").assemble(want)
    else:
        assert got[:4] == b"\0asm"
