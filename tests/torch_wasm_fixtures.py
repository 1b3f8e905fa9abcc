"""The port's copies of the WAT-authored wasm fixtures: the waPC oracle's
``pod-privileged`` module, an OPA-ABI module calling host builtins, a
WASI command module, and the spin loops of the wall-clock deadline tests.

Each is assembled with ``policy_server_tpu_torch/wasm/wat.py``; this
module imports nothing of JAX or of the JAX package, so the card's
smoke script (``chip_smoke.py``, which puts ``tests/`` on its path) loads
it too. A CPU test holds the assembled bytes equal to the JAX package's
fixtures.

* ``wasi_policy_wasm()`` — a WASI command module: argv[1] selects the
  operation, the request JSON arrives on stdin, the verdict JSON leaves
  on stdout; it rejects a request holding ``"privileged":true`` and
  answers ``validate-settings`` with ``{"valid":true}``.
* ``builtin_oracle_wasm()`` — an OPA-ABI module (the full eval surface)
  whose ``eval`` calls ``json.marshal``, ``regex.match``, ``sprintf`` and
  ``units.parse_bytes`` through ``opa_builtin1/2``; a privileged input
  gives two Gatekeeper violations. An OPA value address is the address of
  a NUL-terminated JSON text.
* ``wapc_privileged_wasm()`` — the waPC oracle re-implementation of
  ``pod-privileged`` (``policies/wasm_oracle.py``).
* ``SPIN_WAPC`` / ``SPIN_ON_VALIDATE_WAPC`` — waPC guests that never
  return (the second only on the ``validate`` op, so settings validation
  and environment build succeed).
"""

from __future__ import annotations

import json

from policy_server_tpu_torch.policies.wasm_oracle import oracle_wasm
from policy_server_tpu_torch.wasm.wat import assemble


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


# -- WASI command module -------------------------------------------------------

WASI_PATTERN = '"privileged":true'
WASI_ACCEPT = '{"accepted":true}'
WASI_REJECT = '{"accepted":false,"message":"privileged container denied (wasi)"}'
WASI_VALID = '{"valid":true}'
WASI_SETTINGS_OP = "validate-settings"

# data offsets (memory is zero-filled; gaps keep texts NUL-terminated)
_WASI_PATTERN_OFF = 16
_WASI_ACCEPT_OFF = 48
_WASI_REJECT_OFF = 96
_WASI_VALID_OFF = 192
_WASI_SETTINGS_OP_OFF = 224
# scratch: iovec/result words at 1024, argv pointers at 1056, argv text
# buffer at 1152, stdin buffer from 8192
_WASI_SCRATCH = 1024
_WASI_ARGV_PTRS = 1056
_WASI_ARGV_BUF = 1152
_WASI_STDIN = 8192
_WASI_STDIN_CAP = 180000


def wasi_policy_wasm() -> bytes:
    src = f"""
(module
  (import "wasi_snapshot_preview1" "fd_read"
    (func $fd_read (param i32 i32 i32 i32) (result i32)))
  (import "wasi_snapshot_preview1" "fd_write"
    (func $fd_write (param i32 i32 i32 i32) (result i32)))
  (import "wasi_snapshot_preview1" "proc_exit"
    (func $proc_exit (param i32)))
  (import "wasi_snapshot_preview1" "args_sizes_get"
    (func $args_sizes_get (param i32 i32) (result i32)))
  (import "wasi_snapshot_preview1" "args_get"
    (func $args_get (param i32 i32) (result i32)))
  (memory (export "memory") 4)
  (data (i32.const {_WASI_PATTERN_OFF}) "{_esc(WASI_PATTERN)}")
  (data (i32.const {_WASI_ACCEPT_OFF}) "{_esc(WASI_ACCEPT)}")
  (data (i32.const {_WASI_REJECT_OFF}) "{_esc(WASI_REJECT)}")
  (data (i32.const {_WASI_VALID_OFF}) "{_esc(WASI_VALID)}")
  (data (i32.const {_WASI_SETTINGS_OP_OFF}) "{_esc(WASI_SETTINGS_OP)}")

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

  ;; naive substring search: pattern at $pat (len $plen) in [$buf, $buf+$n)
  (func $find (param $buf i32) (param $n i32) (param $pat i32) (param $plen i32) (result i32)
    (local $i i32)
    block $no
      loop $next
        local.get $i
        local.get $plen
        i32.add
        local.get $n
        i32.gt_u
        br_if $no
        local.get $buf
        local.get $i
        i32.add
        local.get $pat
        local.get $plen
        call $memeq
        if
          i32.const 1
          return
        end
        local.get $i
        i32.const 1
        i32.add
        local.set $i
        br $next
      end
    end
    i32.const 0)

  ;; write a NUL-terminated text to stdout via one ciovec
  (func $print (param $p i32)
    i32.const {_WASI_SCRATCH}
    local.get $p
    i32.store
    i32.const {_WASI_SCRATCH + 4}
    local.get $p
    call $strlen
    i32.store
    i32.const 1
    i32.const {_WASI_SCRATCH}
    i32.const 1
    i32.const {_WASI_SCRATCH + 8}
    call $fd_write
    drop)

  (func (export "_start")
    (local $argc i32)
    (local $arg1 i32)
    (local $total i32)
    (local $n i32)
    ;; argv: operation is argv[1]
    i32.const {_WASI_SCRATCH}
    i32.const {_WASI_SCRATCH + 4}
    call $args_sizes_get
    drop
    i32.const {_WASI_SCRATCH}
    i32.load
    local.set $argc
    i32.const {_WASI_ARGV_PTRS}
    i32.const {_WASI_ARGV_BUF}
    call $args_get
    drop
    local.get $argc
    i32.const 2
    i32.ge_u
    if
      i32.const {_WASI_ARGV_PTRS + 4}
      i32.load
      local.set $arg1
      local.get $arg1
      call $strlen
      i32.const {len(WASI_SETTINGS_OP)}
      i32.eq
      if
        local.get $arg1
        i32.const {_WASI_SETTINGS_OP_OFF}
        i32.const {len(WASI_SETTINGS_OP)}
        call $memeq
        if
          i32.const {_WASI_VALID_OFF}
          call $print
          i32.const 0
          call $proc_exit
        end
      end
    end
    ;; validate: read ALL of stdin
    block $eof
      loop $more
        i32.const {_WASI_SCRATCH}
        i32.const {_WASI_STDIN}
        local.get $total
        i32.add
        i32.store
        i32.const {_WASI_SCRATCH + 4}
        i32.const {_WASI_STDIN_CAP}
        local.get $total
        i32.sub
        i32.store
        i32.const 0
        i32.const {_WASI_SCRATCH}
        i32.const 1
        i32.const {_WASI_SCRATCH + 8}
        call $fd_read
        drop
        i32.const {_WASI_SCRATCH + 8}
        i32.load
        local.set $n
        local.get $n
        i32.eqz
        br_if $eof
        local.get $total
        local.get $n
        i32.add
        local.set $total
        br $more
      end
    end
    i32.const {_WASI_STDIN}
    local.get $total
    i32.const {_WASI_PATTERN_OFF}
    i32.const {len(WASI_PATTERN)}
    call $find
    if
      i32.const {_WASI_REJECT_OFF}
      call $print
    else
      i32.const {_WASI_ACCEPT_OFF}
      call $print
    end
    i32.const 0
    call $proc_exit)
)
"""
    return assemble(src)


# -- OPA / Gatekeeper module with host builtins ----------------------------------

OPA_BUILTIN_IDS = {
    "json.marshal": 0,
    "regex.match": 1,
    "sprintf": 2,
    "units.parse_bytes": 3,
}

OPA_PATTERN = '"privileged": *true'
OPA_FMT = "privileged container denied (%s)"
OPA_ARGS = ["pod"]
OPA_UNITS_ARG = "128Mi"


def builtin_oracle_wasm(
    builtin_ids: dict | None = None,
) -> bytes:
    """Assemble the fixture; ``builtin_ids`` overrides the declared
    name → id map (used to test the unknown-builtin failure surface)."""
    ids = dict(builtin_ids if builtin_ids is not None else OPA_BUILTIN_IDS)
    # JSON texts living in guest memory (each is a VALUE in this module's
    # representation). Offsets assigned with gaps; memory is zero-filled,
    # so every text is NUL-terminated by construction.
    texts = {
        "BUILTINS": json.dumps(ids),
        "ENTRYPOINTS": json.dumps({"policy": 0}),
        "PATTERN": json.dumps(OPA_PATTERN),
        "FMT": json.dumps(OPA_FMT),
        "ARGS": json.dumps(OPA_ARGS),
        "UNITS": json.dumps(OPA_UNITS_ARG),
        "PREFIX": '[{"result":{"violations":[{"msg":',
        "MID": '},{"msg":',
        "SUFFIX": '}]}}]',
        "ACCEPT": '[{"result":{"violations":[]}}]',
    }
    off = {}
    cursor = 16
    for name, text in texts.items():
        off[name] = cursor
        cursor += len(text.encode()) + 16  # NUL gap
    data = "\n  ".join(
        f'(data (i32.const {off[name]}) "{_esc(text)}")'
        for name, text in texts.items()
    )
    src = f"""
(module
  (import "env" "opa_builtin1" (func $builtin1 (param i32 i32 i32) (result i32)))
  (import "env" "opa_builtin2" (func $builtin2 (param i32 i32 i32 i32) (result i32)))
  (memory (export "memory") 2)
  {data}
  (global $heap (mut i32) (i32.const 65536))
  (global $input (mut i32) (i32.const 0))
  (global $data (mut i32) (i32.const 0))
  (global $result (mut i32) (i32.const {off['ACCEPT']}))

  (func $malloc (param $n i32) (result i32)
    (local $p i32)
    global.get $heap
    local.set $p
    global.get $heap
    local.get $n
    i32.add
    i32.const 15
    i32.add
    i32.const -8
    i32.and
    global.set $heap
    local.get $p)
  (export "opa_malloc" (func $malloc))

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

  ;; append NUL-terminated src at dst, return the new write head
  (func $append (param $dst i32) (param $src i32) (result i32)
    (local $n i32)
    local.get $src
    call $strlen
    local.set $n
    local.get $dst
    local.get $src
    local.get $n
    memory.copy
    local.get $dst
    local.get $n
    i32.add)

  ;; a value IS a NUL-terminated JSON text: parse copies + terminates
  (func (export "opa_json_parse") (param $addr i32) (param $len i32) (result i32)
    (local $dst i32)
    local.get $len
    i32.const 1
    i32.add
    call $malloc
    local.set $dst
    local.get $dst
    local.get $addr
    local.get $len
    memory.copy
    local.get $dst
    local.get $len
    i32.add
    i32.const 0
    i32.store8
    local.get $dst)

  (func (export "opa_json_dump") (param $v i32) (result i32)
    local.get $v)

  (func (export "opa_eval_ctx_new") (result i32)
    i32.const 8)
  (func (export "opa_eval_ctx_set_input") (param $ctx i32) (param $v i32)
    local.get $v
    global.set $input)
  (func (export "opa_eval_ctx_set_data") (param $ctx i32) (param $v i32)
    local.get $v
    global.set $data)
  (func (export "opa_eval_ctx_get_result") (param $ctx i32) (result i32)
    global.get $result)

  (func (export "builtins") (result i32)
    i32.const {off['BUILTINS']})
  (func (export "entrypoints") (result i32)
    i32.const {off['ENTRYPOINTS']})

  (func (export "eval") (param $ctx i32) (result i32)
    (local $marshaled i32)
    (local $matched i32)
    (local $msg i32)
    (local $units i32)
    (local $buf i32)
    (local $p i32)
    ;; marshaled = json.marshal(input)
    i32.const {ids.get('json.marshal', 0)}
    i32.const 0
    global.get $input
    call $builtin1
    local.set $marshaled
    ;; matched = regex.match(PATTERN, marshaled)
    i32.const {ids.get('regex.match', 1)}
    i32.const 0
    i32.const {off['PATTERN']}
    local.get $marshaled
    call $builtin2
    local.set $matched
    ;; the value text of true is "true": test its first byte
    local.get $matched
    i32.load8_u
    i32.const 116
    i32.eq
    if
      ;; msg = sprintf(FMT, ARGS); units = units.parse_bytes(UNITS)
      i32.const {ids.get('sprintf', 2)}
      i32.const 0
      i32.const {off['FMT']}
      i32.const {off['ARGS']}
      call $builtin2
      local.set $msg
      i32.const {ids.get('units.parse_bytes', 3)}
      i32.const 0
      i32.const {off['UNITS']}
      call $builtin1
      local.set $units
      ;; result = PREFIX + msg + MID + units + SUFFIX
      i32.const 4096
      call $malloc
      local.set $buf
      local.get $buf
      i32.const {off['PREFIX']}
      call $append
      local.get $msg
      call $append
      i32.const {off['MID']}
      call $append
      local.get $units
      call $append
      i32.const {off['SUFFIX']}
      call $append
      local.set $p
      local.get $p
      i32.const 0
      i32.store8
      local.get $buf
      global.set $result
    else
      i32.const {off['ACCEPT']}
      global.set $result
    end
    i32.const 0)
)
"""
    return assemble(src)


# -- wall-clock deadline guests -----------------------------------------------

# a guest that never returns: only the clock (or fuel) can stop it
SPIN_WAPC = """
(module
  (memory (export "memory") 1)
  (func (export "__guest_call") (param $op i32) (param $n i32) (result i32)
    loop $spin
      br $spin
    end
    i32.const 1)
)
"""

# spins on the 8-byte "validate" op only; any other op (validate_settings,
# protocol_version) answers {"valid":true} — so environment BUILD succeeds
# and the deadline trips at evaluation time
SPIN_ON_VALIDATE_WAPC = """
(module
  (import "wapc" "__guest_response" (func $guest_response (param i32 i32)))
  (memory (export "memory") 1)
  (data (i32.const 8) "{\\22valid\\22:true}")
  (func (export "__guest_call") (param $op_len i32) (param $n i32) (result i32)
    local.get $op_len
    i32.const 8
    i32.eq
    if
      loop $spin
        br $spin
      end
    end
    i32.const 8
    i32.const 14
    call $guest_response
    i32.const 1)
)
"""


# -- waPC ----------------------------------------------------------------------


def wapc_privileged_wasm() -> bytes:
    """The waPC oracle's ``pod-privileged`` module."""
    return oracle_wasm("pod-privileged")
