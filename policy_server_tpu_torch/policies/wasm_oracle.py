"""WAT-authored wasm oracle policies for the differential harness.

These are INDEPENDENT re-implementations of builtin policy semantics,
written in WebAssembly text (assembled by wasm/wat.py, executed by
wasm/interp.py through the waPC protocol, wasm/wapc.py). They share
nothing with the device path — not the IR, not the tensor codec, not the
feature schema; their input is the flat ``key\\0value\\0`` payload ABI —
so a lowering bug in ops/* cannot cancel out in the differential the way
it could when the oracle interpreted the same IR. Together with the upstream-compiled Gatekeeper fixtures
(wasm/opa.py) they make ``--evaluation-backend`` comparisons run against
REAL wasm execution, like the reference's wasmtime substrate
(src/evaluation/precompiled_policy.rs:46-64).

String scanning (prefix/suffix/equality over the flat entries) is
implemented in wasm itself; each policy contributes a ``$match`` (or a
whole ``$validate``) over the shared prelude."""

from __future__ import annotations

import functools

from policy_server_tpu_torch.wasm.wapc import KubewardenWapcPolicy
from policy_server_tpu_torch.wasm.wat import assemble

ACCEPT = '{"accepted":true}'
REJECT = '{"accepted":false,"message":"rejected by wasm oracle policy"}'
VALID = '{"valid":true}'

# fixed data layout (bytes): 8 "validate", 32 ACCEPT, 64 REJECT, 160 VALID,
# 192.. policy strings, heap from 4096
_VALIDATE_OFF = 8
_ACCEPT_OFF = 32
_REJECT_OFF = 64
_VALID_OFF = 160
_STRINGS_OFF = 192
_HEAP_BASE = 4096


def _prelude(extra_data: list[tuple[int, str]], policy_funcs: str) -> str:
    data = "\n  ".join(
        [
            f'(data (i32.const {_VALIDATE_OFF}) "validate")',
            f'(data (i32.const {_ACCEPT_OFF}) "{_esc(ACCEPT)}")',
            f'(data (i32.const {_REJECT_OFF}) "{_esc(REJECT)}")',
            f'(data (i32.const {_VALID_OFF}) "{_esc(VALID)}")',
        ]
        + [f'(data (i32.const {off}) "{_esc(text)}")' for off, text in extra_data]
    )
    return f"""
(module
  (import "wapc" "__guest_request" (func $guest_request (param i32 i32)))
  (import "wapc" "__guest_response" (func $guest_response (param i32 i32)))
  (import "wapc" "__guest_error" (func $guest_error (param i32 i32)))
  (memory (export "memory") 4)
  {data}
  (global $flat (mut i32) (i32.const 1))
  (export "__flat_abi" (global $flat))
  (global $heap (mut i32) (i32.const {_HEAP_BASE}))
  (global $payload (mut i32) (i32.const 0))
  (global $payload_len (mut i32) (i32.const 0))

  (func $malloc (param $n i32) (result i32)
    (local $p i32)
    global.get $heap
    local.set $p
    global.get $heap
    local.get $n
    i32.add
    i32.const 7
    i32.add
    i32.const -8
    i32.and
    global.set $heap
    local.get $p)

  (func $strlen (param $p i32) (result i32)
    (local $n i32)
    block $done
      loop $scan
        local.get $p
        local.get $n
        i32.add
        i32.load8_u
        i32.eqz
        br_if $done
        local.get $n
        i32.const 1
        i32.add
        local.set $n
        br $scan
      end
    end
    local.get $n)

  ;; bytes at a[0..len) equal bytes at b[0..len)
  (func $memeq (param $a i32) (param $b i32) (param $len i32) (result i32)
    (local $i i32)
    block $ne
      loop $next
        local.get $i
        local.get $len
        i32.ge_u
        if
          i32.const 1
          return
        end
        local.get $a
        local.get $i
        i32.add
        i32.load8_u
        local.get $b
        local.get $i
        i32.add
        i32.load8_u
        i32.ne
        br_if $ne
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        br $next
      end
    end
    i32.const 0)

  (func $str_eq (param $a i32) (param $alen i32) (param $b i32) (param $blen i32) (result i32)
    local.get $alen
    local.get $blen
    i32.ne
    if
      i32.const 0
      return
    end
    local.get $a
    local.get $b
    local.get $alen
    call $memeq)

  (func $starts_with (param $p i32) (param $len i32) (param $pre i32) (param $prelen i32) (result i32)
    local.get $len
    local.get $prelen
    i32.lt_u
    if
      i32.const 0
      return
    end
    local.get $p
    local.get $pre
    local.get $prelen
    call $memeq)

  (func $ends_with (param $p i32) (param $len i32) (param $suf i32) (param $suflen i32) (result i32)
    local.get $len
    local.get $suflen
    i32.lt_u
    if
      i32.const 0
      return
    end
    local.get $p
    local.get $len
    i32.add
    local.get $suflen
    i32.sub
    local.get $suf
    local.get $suflen
    call $memeq)

{policy_funcs}

  ;; walk flat entries calling $match(key,klen,val,vlen); 1 ⇒ violation
  (func $scan_entries (result i32)
    (local $p i32) (local $end i32)
    (local $k i32) (local $klen i32) (local $v i32) (local $vlen i32)
    global.get $payload
    local.set $p
    global.get $payload
    global.get $payload_len
    i32.add
    local.set $end
    block $done
      loop $next
        local.get $p
        local.get $end
        i32.ge_u
        br_if $done
        local.get $p
        local.set $k
        local.get $k
        call $strlen
        local.set $klen
        local.get $k
        local.get $klen
        i32.add
        i32.const 1
        i32.add
        local.set $v
        local.get $v
        call $strlen
        local.set $vlen
        local.get $v
        local.get $vlen
        i32.add
        i32.const 1
        i32.add
        local.set $p
        local.get $k
        local.get $klen
        local.get $v
        local.get $vlen
        call $match
        if
          i32.const 1
          return
        end
        br $next
      end
    end
    i32.const 0)

  (func (export "__guest_call") (param $op_len i32) (param $payload_len i32) (result i32)
    (local $op i32)
    local.get $op_len
    call $malloc
    local.set $op
    local.get $payload_len
    call $malloc
    global.set $payload
    local.get $payload_len
    global.set $payload_len
    local.get $op
    global.get $payload
    call $guest_request
    ;; operation == "validate" ?
    local.get $op
    local.get $op_len
    i32.const {_VALIDATE_OFF}
    i32.const 8
    call $str_eq
    if
      call $validate
      if
        i32.const {_REJECT_OFF}
        i32.const {len(REJECT)}
        call $guest_response
      else
        i32.const {_ACCEPT_OFF}
        i32.const {len(ACCEPT)}
        call $guest_response
      end
    else
      ;; validate_settings / anything else → settings are valid
      i32.const {_VALID_OFF}
      i32.const {len(VALID)}
      call $guest_response
    end
    i32.const 1)
)
"""


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


class _Strings:
    """Assigns data offsets for policy string constants."""

    def __init__(self, base: int = _STRINGS_OFF):
        self.off = base
        self.data: list[tuple[int, str]] = []

    def add(self, text: str) -> tuple[int, int]:
        off = self.off
        self.data.append((off, text))
        self.off += len(text.encode()) + 1
        return off, len(text.encode())


def _container_item_helpers(s: _Strings) -> str:
    """WAT helpers enforcing the flat-ABI list discipline: a key reaches a
    container item only through ``spec.<list>.#<digits>`` — mapping keys
    can never render a ``#``-leading segment (wapc.flatten_payload), so
    adversarial mapping-shaped ``containers`` cannot spoof a match.
    Mirrors the tensor codec, whose container star axes iterate LIST
    items only (entry wrappers for mappings expose no container fields)."""
    pres = [
        s.add("request.object.spec.containers.#"),
        s.add("request.object.spec.initContainers.#"),
        s.add("request.object.spec.ephemeralContainers.#"),
    ]
    arms = "\n".join(
        f"""    local.get $k
    local.get $klen
    i32.const {off}
    i32.const {ln}
    call $starts_with
    if
      local.get $k
      local.get $klen
      i32.const {ln}
      local.get $suf
      local.get $suflen
      call $digits_then_suffix
      if
        i32.const 1
        return
      end
    end"""
        for off, ln in pres
    )
    return f"""
  ;; key[i..] is 1+ ASCII digits immediately followed by exactly $suf
  (func $digits_then_suffix (param $k i32) (param $klen i32) (param $i i32) (param $suf i32) (param $suflen i32) (result i32)
    (local $n i32) (local $c i32)
    block $done
      loop $scan
        local.get $i
        local.get $klen
        i32.ge_u
        br_if $done
        local.get $k
        local.get $i
        i32.add
        i32.load8_u
        local.set $c
        local.get $c
        i32.const 48
        i32.lt_u
        br_if $done
        local.get $c
        i32.const 57
        i32.gt_u
        br_if $done
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        local.get $n
        i32.const 1
        i32.add
        local.set $n
        br $scan
      end
    end
    local.get $n
    i32.eqz
    if
      i32.const 0
      return
    end
    local.get $klen
    local.get $i
    i32.sub
    local.get $suflen
    i32.ne
    if
      i32.const 0
      return
    end
    local.get $k
    local.get $i
    i32.add
    local.get $suf
    local.get $suflen
    call $memeq)

  ;; key == spec.(containers|initContainers|ephemeralContainers).#N + $suf
  (func $container_item_suffix (param $k i32) (param $klen i32) (param $suf i32) (param $suflen i32) (result i32)
{arms}
    i32.const 0)
"""


def _simple_match_policy(
    match_body: str, strings: _Strings, extra_funcs: str = ""
) -> str:
    funcs = f"""{extra_funcs}
  (func $match (param $k i32) (param $klen i32) (param $v i32) (param $vlen i32) (result i32)
{match_body})

  (func $validate (result i32)
    call $scan_entries)
"""
    return _prelude(strings.data, funcs)


# ---------------------------------------------------------------------------
# The policies
# ---------------------------------------------------------------------------


def _always_happy() -> str:
    s = _Strings()
    return _simple_match_policy("    i32.const 0", s)


def _always_unhappy() -> str:
    s = _Strings()
    funcs = """
  (func $match (param $k i32) (param $klen i32) (param $v i32) (param $vlen i32) (result i32)
    i32.const 0)

  (func $validate (result i32)
    i32.const 1)
"""
    return _prelude(s.data, funcs)


def _pod_privileged() -> str:
    s = _Strings()
    helpers = _container_item_helpers(s)
    suf, suflen = s.add(".securityContext.privileged")
    true_off, true_len = s.add("btrue")  # type-tagged bool true
    body = f"""    local.get $k
    local.get $klen
    i32.const {suf}
    i32.const {suflen}
    call $container_item_suffix
    if
      local.get $v
      local.get $vlen
      i32.const {true_off}
      i32.const {true_len}
      call $str_eq
      return
    end
    i32.const 0"""
    return _simple_match_policy(body, s, helpers)


def _host_namespaces() -> str:
    s = _Strings()
    keys = [
        s.add("request.object.spec.hostNetwork"),
        s.add("request.object.spec.hostPID"),
        s.add("request.object.spec.hostIPC"),
    ]
    true_off, true_len = s.add("btrue")  # type-tagged bool true
    checks = []
    for off, length in keys:
        checks.append(f"""    local.get $k
    local.get $klen
    i32.const {off}
    i32.const {length}
    call $str_eq
    if
      local.get $v
      local.get $vlen
      i32.const {true_off}
      i32.const {true_len}
      call $str_eq
      return
    end""")
    body = "\n".join(checks) + "\n    i32.const 0"
    return _simple_match_policy(body, s)


def _namespace_validate() -> str:
    """Two-pass: find request.namespace, then compare against every
    settings.denied_namespaces.N value."""
    s = _Strings()
    ns_key, ns_key_len = s.add("request.namespace")
    denied_pre, denied_pre_len = s.add("settings.denied_namespaces.")
    funcs = f"""
  (global $ns (mut i32) (i32.const 0))
  (global $ns_len (mut i32) (i32.const 0))

  ;; pass 1: remember the request namespace value
  (func $match (param $k i32) (param $klen i32) (param $v i32) (param $vlen i32) (result i32)
    local.get $k
    local.get $klen
    i32.const {ns_key}
    i32.const {ns_key_len}
    call $str_eq
    if
      local.get $v
      global.set $ns
      local.get $vlen
      global.set $ns_len
    end
    i32.const 0)

  ;; pass 2: any denied namespace equal to it?
  (func $match2 (param $k i32) (param $klen i32) (param $v i32) (param $vlen i32) (result i32)
    local.get $k
    local.get $klen
    i32.const {denied_pre}
    i32.const {denied_pre_len}
    call $starts_with
    if
      local.get $v
      local.get $vlen
      global.get $ns
      global.get $ns_len
      call $str_eq
      return
    end
    i32.const 0)

  (func $scan_entries2 (result i32)
    (local $p i32) (local $end i32)
    (local $k i32) (local $klen i32) (local $v i32) (local $vlen i32)
    global.get $payload
    local.set $p
    global.get $payload
    global.get $payload_len
    i32.add
    local.set $end
    block $done
      loop $next
        local.get $p
        local.get $end
        i32.ge_u
        br_if $done
        local.get $p
        local.set $k
        local.get $k
        call $strlen
        local.set $klen
        local.get $k
        local.get $klen
        i32.add
        i32.const 1
        i32.add
        local.set $v
        local.get $v
        call $strlen
        local.set $vlen
        local.get $v
        local.get $vlen
        i32.add
        i32.const 1
        i32.add
        local.set $p
        local.get $k
        local.get $klen
        local.get $v
        local.get $vlen
        call $match2
        if
          i32.const 1
          return
        end
        br $next
      end
    end
    i32.const 0)

  (func $validate (result i32)
    call $scan_entries
    drop
    global.get $ns_len
    i32.eqz
    if
      i32.const 0
      return
    end
    call $scan_entries2)
"""
    return _prelude(s.data, funcs)


def _disallow_latest_tag() -> str:
    """Image must carry an explicit non-latest tag (or a digest)."""
    s = _Strings()
    helpers = _container_item_helpers(s)
    suf, suflen = s.add(".image")
    latest, latest_len = s.add(":latest")
    funcs = f"""{helpers}
  ;; is the image value untagged (no ':' or '@' after the last '/')?
  (func $untagged (param $v i32) (param $vlen i32) (result i32)
    (local $i i32) (local $start i32) (local $c i32)
    ;; find position after last '/'
    block $found
      local.get $vlen
      local.set $i
      loop $back
        local.get $i
        i32.eqz
        br_if $found
        local.get $i
        i32.const 1
        i32.sub
        local.set $i
        local.get $v
        local.get $i
        i32.add
        i32.load8_u
        i32.const 47  ;; '/'
        i32.eq
        if
          local.get $i
          i32.const 1
          i32.add
          local.set $start
          br $found
        end
        br $back
      end
    end
    ;; scan for ':' (58) or '@' (64) from $start
    local.get $start
    local.set $i
    block $done
      loop $scan
        local.get $i
        local.get $vlen
        i32.ge_u
        br_if $done
        local.get $v
        local.get $i
        i32.add
        i32.load8_u
        local.set $c
        local.get $c
        i32.const 58
        i32.eq
        if
          i32.const 0
          return
        end
        local.get $c
        i32.const 64
        i32.eq
        if
          i32.const 0
          return
        end
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        br $scan
      end
    end
    i32.const 1)

  (func $match (param $k i32) (param $klen i32) (param $v i32) (param $vlen i32) (result i32)
    local.get $k
    local.get $klen
    i32.const {suf}
    i32.const {suflen}
    call $container_item_suffix
    if
      ;; null ('z') means image absent → no violation; any other
      ;; non-string value is present-but-not-a-string, which the device
      ;; treats as untagged (Exists & ~matches-regex) → violation
      local.get $vlen
      i32.eqz
      if
        i32.const 0
        return
      end
      local.get $v
      i32.load8_u
      i32.const 122  ;; 'z'
      i32.eq
      if
        i32.const 0
        return
      end
      local.get $v
      i32.load8_u
      i32.const 115  ;; 's'
      i32.ne
      if
        i32.const 1
        return
      end
      ;; violation when untagged OR ends with :latest (skip the tag byte)
      local.get $v
      i32.const 1
      i32.add
      local.get $vlen
      i32.const 1
      i32.sub
      call $untagged
      if
        i32.const 1
        return
      end
      local.get $v
      local.get $vlen
      i32.const {latest}
      i32.const {latest_len}
      call $ends_with
      return
    end
    i32.const 0)

  (func $validate (result i32)
    call $scan_entries)
"""
    return _prelude(s.data, funcs)


WAT_SOURCES = {
    "always-happy": _always_happy,
    "always-unhappy": _always_unhappy,
    "pod-privileged": _pod_privileged,
    "host-namespaces": _host_namespaces,
    "namespace-validate": _namespace_validate,
    "disallow-latest-tag": _disallow_latest_tag,
}


@functools.lru_cache(maxsize=None)
def oracle_wasm(name: str) -> bytes:
    """Assembled wasm bytes for one oracle policy."""
    return assemble(WAT_SOURCES[name]())


@functools.lru_cache(maxsize=None)
def oracle_policy(name: str) -> KubewardenWapcPolicy:
    return KubewardenWapcPolicy(oracle_wasm(name))
