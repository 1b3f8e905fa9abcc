"""The plain reference: what each webhook call must answer.

Plain Python over the review JSON, the policies file and the signature
store. It imports nothing of the program. Each policy family is written out
from its documented semantics: a list of deny rules, the first that holds
gives the rejection's message; an allowed request of a mutating family
carries its JSONPatch; monitor mode answers allowed with no status and no
patch; a group answers its expression's verdict, short-circuited left to
right, with a cause for each member it evaluated that denied.

Typing follows the policy language: a boolean field is true only when it is
the JSON ``true``; a string test on a missing or non-string value fails;
``exists`` means present and not null.
"""

from __future__ import annotations

import base64
import fnmatch
import hashlib
import json
import re
from typing import Any, Callable

Payload = dict

CONTAINER_LISTS = ("containers", "initContainers", "ephemeralContainers")
APPARMOR_PREFIX = "container.apparmor.security.beta.kubernetes.io/"
GROUP_MUTATION_MESSAGE = "mutation is not allowed inside of policy group"
TAGGED = re.compile(r"^(?:[^/]*/)*[^/]*[:@][^/]*$")
SIGNATURE_TYPE = "cosign container image signature"


def _get(value: Any, *keys: str) -> Any:
    for k in keys:
        if not isinstance(value, dict):
            return None
        value = value.get(k)
    return value


def _is_true(value: Any) -> bool:
    return value is True


def _is_str(value: Any) -> bool:
    return isinstance(value, str)


def _items(value: Any) -> list:
    """The elements a rule quantifies over: a list's items, or a map's
    entries as (key, value) in sorted key order."""
    if isinstance(value, list):
        return value
    if isinstance(value, dict):
        return [{"__key__": str(k), "__value__": value[k]} for k in sorted(value, key=str)]
    return []


def containers(p: Payload) -> list:
    spec = _get(p, "object", "spec")
    out = []
    for name in CONTAINER_LISTS:
        out.extend(_items(_get(spec, name)))
    return out


def any_container(p: Payload, pred: Callable[[Any], bool]) -> bool:
    return any(pred(c) for c in containers(p))


def _const(message: str) -> Callable[[Payload], str]:
    return lambda _p: message


# -- families ----------------------------------------------------------------
# each: settings -> (rules, mutator or None)


def always_happy(_s: dict):
    return [], None


def always_unhappy(s: dict):
    return [(lambda p: True, _const(s.get("message", "this policy always rejects")))], None


def namespace_validate(s: dict):
    denied = list(s["denied_namespaces"])
    return [(
        lambda p: _is_str(p.get("namespace")) and p["namespace"] in denied,
        lambda p: f"namespace '{p.get('namespace')}' is denied",
    )], None


def pod_privileged(_s: dict):
    return [(
        lambda p: any_container(p, lambda c: _is_true(_get(c, "securityContext", "privileged"))),
        _const("Privileged container is not allowed"),
    )], None


def psp_capabilities(s: dict):
    allowed = list(s.get("allowed_capabilities") or [])
    drop = list(s.get("required_drop_capabilities") or [])
    add = list(s.get("default_add_capabilities") or [])
    rules = []
    if "*" not in allowed:
        def bad(c: Any) -> bool:
            return any(
                not allowed or not (_is_str(cap) and cap in allowed)
                for cap in _items(_get(c, "securityContext", "capabilities", "add"))
            )
        rules.append((
            lambda p: any_container(p, bad),
            _const("PSP capabilities policies doesn't allow these capabilities to be added"),
        ))

    def mutate(p: Payload) -> list | None:
        if not drop and not add:
            return None
        ops: list = []
        spec = _get(p, "object", "spec") or {}
        for list_name in CONTAINER_LISTS:
            lst = spec.get(list_name)
            if not isinstance(lst, list):
                continue
            for i, c in enumerate(lst):
                if not isinstance(c, dict):
                    continue
                base = f"/spec/{list_name}/{i}/securityContext"
                sc = c.get("securityContext")
                caps = sc.get("capabilities") if isinstance(sc, dict) else None
                have_drop = list(caps.get("drop") or []) if isinstance(caps, dict) else []
                have_add = list(caps.get("add") or []) if isinstance(caps, dict) else []
                new_drop = have_drop + [x for x in drop if x not in have_drop]
                new_add = have_add + [x for x in add if x not in have_add]
                if new_drop == have_drop and new_add == have_add:
                    continue
                if not isinstance(sc, dict):
                    ops.append({"op": "add", "path": base, "value": {}})
                if not isinstance(caps, dict):
                    ops.append({"op": "add", "path": f"{base}/capabilities", "value": {}})
                if new_drop != have_drop:
                    ops.append({"op": "add", "path": f"{base}/capabilities/drop", "value": new_drop})
                if new_add != have_add:
                    ops.append({"op": "add", "path": f"{base}/capabilities/add", "value": new_add})
        return ops or None

    return rules, mutate


def psp_apparmor(s: dict):
    allowed = list(s.get("allowed_profiles", ["runtime/default"]))

    def bad(p: Payload) -> bool:
        return any(
            e["__key__"].startswith(APPARMOR_PREFIX)
            and not (_is_str(e["__value__"]) and e["__value__"] in allowed)
            for e in _items(_get(p, "object", "metadata", "annotations"))
        )
    return [(bad, _const("These AppArmor profiles are not allowed: not in the allowed list"))], None


def _image(c: Any) -> Any:
    return _get(c, "image")


def trusted_repos(s: dict):
    reg = s.get("registries") or {}
    tags = s.get("tags") or {}
    images = s.get("images") or {}
    rules: list = []
    if reg.get("allow"):
        prefixes = [r.rstrip("/") + "/" for r in reg["allow"]]
        rules.append((
            lambda p: any_container(p, lambda c: not (
                _is_str(_image(c)) and any(_image(c).startswith(x) for x in prefixes))),
            _const("not coming from an allowed registry"),
        ))
    if reg.get("reject"):
        rejected = [r.rstrip("/") + "/" for r in reg["reject"]]
        rules.append((
            lambda p: any_container(p, lambda c: _is_str(_image(c)) and any(
                _image(c).startswith(x) for x in rejected)),
            _const("coming from a rejected registry"),
        ))
    for t in tags.get("reject") or []:
        rules.append((
            lambda p, t=t: any_container(
                p, lambda c: _is_str(_image(c)) and _image(c).endswith(f":{t}")),
            _const(f"tag '{t}' is rejected"),
        ))
    if images.get("allow"):
        allow = list(images["allow"])
        rules.append((
            lambda p: any_container(p, lambda c: not (
                _is_str(_image(c)) and any(fnmatch.fnmatchcase(_image(c), g) for g in allow))),
            _const("image is not in the allowed list"),
        ))
    for g in images.get("reject") or []:
        rules.append((
            lambda p, g=g: any_container(
                p, lambda c: _is_str(_image(c)) and fnmatch.fnmatchcase(_image(c), g)),
            _const(f"image matches rejected pattern '{g}'"),
        ))
    return rules, None


class SignatureChecker:
    """Ed25519 verification of an image's bundle in the signature store:
    authentic under a configured key, and its payload binds this image
    reference to a sha256 manifest digest. ``skip`` is the control: it
    trusts the glob alone."""

    def __init__(self, entries: list, store: str | None, skip: bool = False):
        self.entries = entries
        self.store = store
        self.skip = skip
        self._memo: dict[str, bool] = {}

    def matched(self, image: str) -> bool:
        return any(fnmatch.fnmatchcase(image, e["image"]) for e in self.entries)

    def verified(self, image: str) -> bool:
        if self.skip:
            return True
        if image not in self._memo:
            self._memo[image] = self._verify(image)
        return self._memo[image]

    def _verify(self, image: str) -> bool:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey
        from cryptography.hazmat.primitives.serialization import load_pem_public_key

        if self.store is None:
            return False
        path = f"{self.store}/{hashlib.sha256(image.encode()).hexdigest()}.sig.json"
        try:
            with open(path, encoding="utf-8") as f:
                bundle = json.load(f)
        except (OSError, ValueError):
            return False
        for entry in self.entries:
            if not fnmatch.fnmatchcase(image, entry["image"]):
                continue
            keys = []
            for pem in entry["pubKeys"]:
                key = load_pem_public_key(pem.encode())
                if isinstance(key, Ed25519PublicKey):
                    keys.append(key)
            for sig in bundle.get("signatures") or []:
                payload = base64.b64decode(sig["payload"])
                signature = base64.b64decode(sig["signature"])
                for key in keys:
                    try:
                        key.verify(signature, payload)
                    except InvalidSignature:
                        continue
                    doc = json.loads(payload)
                    critical = doc.get("critical") or {}
                    digest = str(_get(critical, "image", "docker-manifest-digest"))
                    if (critical.get("type") == SIGNATURE_TYPE
                            and _get(critical, "identity", "docker-reference") == image
                            and digest.startswith("sha256:")
                            and all((doc.get("optional") or {}).get(k) == v
                                    for k, v in (entry.get("annotations") or {}).items())):
                        return True
        return False


def pod_images(p: Payload) -> list[str]:
    seen: dict[str, None] = {}
    for c in containers(p):
        img = _image(c)
        if _is_str(img) and img:
            seen.setdefault(img, None)
    return list(seen)


def verify_image_signatures(s: dict, skip_crypto: bool = False):
    checker = SignatureChecker(list(s["signatures"]), s.get("signatureStore"), skip_crypto)

    def unverified(p: Payload) -> list[str]:
        return [i for i in pod_images(p) if checker.matched(i) and not checker.verified(i)]

    return [
        (
            lambda p: any_container(
                p, lambda c: _image(c) is not None
                and not (_is_str(_image(c)) and checker.matched(_image(c)))),
            _const("image signature verification failed: image matches no signature entry"),
        ),
        (
            lambda p: len(unverified(p)) > 0,
            lambda p: "image signature verification failed for: "
            + ", ".join(f"'{i}'" for i in unverified(p)),
        ),
    ], None


def disallow_latest_tag(_s: dict):
    def bad(c: Any) -> bool:
        img = _image(c)
        if img is None:
            return False
        if not _is_str(img):
            return True
        return TAGGED.search(img) is None or img.endswith(":latest")
    return [(lambda p: any_container(p, bad),
             _const("images must have an explicit, non-latest tag"))], None


def host_namespaces(s: dict):
    rules = []
    for key, flag in (("allow_host_network", "hostNetwork"),
                      ("allow_host_pid", "hostPID"),
                      ("allow_host_ipc", "hostIPC")):
        if not s.get(key, False):
            rules.append((
                lambda p, flag=flag: _is_true(_get(p, "object", "spec", flag)),
                _const(f"Pod has {flag} enabled, but this is not allowed"),
            ))
    return rules, None


def readonly_root_fs(_s: dict):
    return [(
        lambda p: any_container(
            p, lambda c: not _is_true(_get(c, "securityContext", "readOnlyRootFilesystem"))),
        _const("containers must set securityContext.readOnlyRootFilesystem to true"),
    )], None


def _label_rules(s: dict, what: str):
    mandatory = list(s.get(f"mandatory_{what}s") or [])
    denied = list(s.get(f"denied_{what}s") or [])
    field = f"{what}s"
    rules = []
    for name in mandatory:
        rules.append((
            lambda p, name=name: _get(p, "object", "metadata", field, name) is None,
            _const(f"mandatory {what} {name!r} is missing"),
        ))
    if denied:
        rules.append((
            lambda p: any(e["__key__"] in denied
                          for e in _items(_get(p, "object", "metadata", field))),
            _const(f"a denied {what} is present"),
        ))
    return rules, None


def safe_labels(s: dict):
    return _label_rules(s, "label")


def safe_annotations(s: dict):
    return _label_rules(s, "annotation")


def replicas_max(s: dict):
    limit = float(s["max_replicas"])

    def bad(p: Payload) -> bool:
        v = _get(p, "object", "spec", "replicas")
        return isinstance(v, (int, float)) and not isinstance(v, bool) and float(v) > limit
    return [(bad, _const(f"spec.replicas must not exceed {int(limit)}"))], None


def run_as_non_root(_s: dict):
    return [(
        lambda p: not _is_true(_get(p, "object", "spec", "securityContext", "runAsNonRoot"))
        and any_container(p, lambda c: not _is_true(_get(c, "securityContext", "runAsNonRoot"))),
        _const("pods must set runAsNonRoot at pod or container level"),
    )], None


def allowed_proc_mount_types(s: dict):
    allowed = list(s.get("allowed_types", ["Default"]))

    def bad(c: Any) -> bool:
        v = _get(c, "securityContext", "procMount")
        return v is not None and not (_is_str(v) and v in allowed)
    return [(lambda p: any_container(p, bad), _const(f"procMount must be one of {allowed}"))], None


def hostpaths(s: dict):
    prefixes = [e["pathPrefix"] for e in s.get("allowed_host_paths") or []]

    def bad(v: Any) -> bool:
        path = _get(v, "hostPath", "path")
        if path is None:
            return False
        return not prefixes or not (_is_str(path) and any(path.startswith(x) for x in prefixes))
    return [(lambda p: any(bad(v) for v in _items(_get(p, "object", "spec", "volumes"))),
             _const("hostPath volume is not allowed"))], None


def raw_mutation(_s: dict):
    def mutate(p: Payload) -> list | None:
        if isinstance(p, dict) and "validated" not in p:
            return [{"op": "add", "path": "/validated", "value": True}]
        return None
    return [(lambda p: _is_true(p.get("forbidden")), _const("the request is forbidden"))], mutate


def _int_id(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def user_group_psp(s: dict):
    rules = []
    for key, field in (("run_as_user", "runAsUser"), ("run_as_group", "runAsGroup")):
        doc = s.get(key) or {}
        rule = doc.get("rule", "RunAsAny")
        ranges = doc.get("ranges") or []
        if rule == "RunAsAny":
            continue
        if rule == "MustRunAsNonRoot":
            def bad(v: Any) -> bool:
                return v is not None and _int_id(v) and v == 0
            message = f"{field} must not be 0 (root)"
        else:
            def bad(v: Any, ranges=ranges) -> bool:
                return v is not None and not (_int_id(v) and any(
                    int(r["min"]) <= v <= int(r["max"]) for r in ranges))
            message = f"{field} is outside the allowed ranges"
        rules.append((lambda p, bad=bad, field=field: bad(
            _get(p, "object", "spec", "securityContext", field)), _const(message)))
        rules.append((lambda p, bad=bad, field=field: any_container(
            p, lambda c: bad(_get(c, "securityContext", field))), _const(message)))
    return rules, None


def sysctl_psp(s: dict):
    forbidden = list(s["forbidden_sysctls"])
    allowed = list(s.get("allowed_unsafe_sysctls") or [])

    def bad(e: Any) -> bool:
        name = _get(e, "name")
        if name is None or not _is_str(name):
            return False
        hit = any(fnmatch.fnmatchcase(name, g) for g in forbidden)
        return hit and name not in allowed
    return [(lambda p: any(bad(e) for e in _items(
        _get(p, "object", "spec", "securityContext", "sysctls"))),
        _const("pod sets a forbidden sysctl"))], None


def selinux_psp(s: dict):
    if s.get("rule", "RunAsAny") == "RunAsAny":
        return [], None
    rules = []
    for field in ("level", "role", "type", "user"):
        if field not in s:
            continue
        expected = s[field]

        def differs(v: Any, expected=expected) -> bool:
            return _is_str(v) and v != expected
        message = _const(f"seLinuxOptions.{field} must be '{expected}'")
        rules.append((lambda p, f=field, d=differs: d(
            _get(p, "object", "spec", "securityContext", "seLinuxOptions", f)), message))
        rules.append((lambda p, f=field, d=differs: any_container(
            p, lambda c: d(_get(c, "securityContext", "seLinuxOptions", f))), message))
    return rules, None


FAMILIES: dict[str, Callable] = {
    "always-happy": always_happy,
    "always-unhappy": always_unhappy,
    "namespace-validate": namespace_validate,
    "pod-privileged": pod_privileged,
    "psp-capabilities": psp_capabilities,
    "psp-apparmor": psp_apparmor,
    "trusted-repos": trusted_repos,
    "verify-image-signatures": verify_image_signatures,
    "disallow-latest-tag": disallow_latest_tag,
    "host-namespaces": host_namespaces,
    "readonly-root-fs": readonly_root_fs,
    "safe-labels": safe_labels,
    "safe-annotations": safe_annotations,
    "replicas-max": replicas_max,
    "run-as-non-root": run_as_non_root,
    "allowed-proc-mount-types": allowed_proc_mount_types,
    "hostpaths": hostpaths,
    "raw-mutation": raw_mutation,
    "user-group-psp": user_group_psp,
    "sysctl-psp": sysctl_psp,
    "selinux-psp": selinux_psp,
}

# -- groups ------------------------------------------------------------------

_TOKEN = re.compile(r"\s*(?:(&&)|(\|\|)|(!)|(\()|(\))|([A-Za-z_][A-Za-z0-9_]*)\s*\(\s*\)|(true|false)\b)")


def parse_expression(text: str) -> Any:
    """``a() || (b() && !c())`` → nested tuples: ("or", l, r), ("and", l, r),
    ("not", x), ("call", name), ("lit", bool)."""
    tokens = []
    pos = 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"cannot parse {text!r} at {pos}")
        kinds = ("and", "or", "not", "(", ")", "call", "lit")
        idx = next(i for i in range(7) if m.group(i + 1) is not None)
        tokens.append((kinds[idx], m.group(idx + 1)))
        pos = m.end()
        while pos < len(text) and text[pos].isspace():
            pos += 1
    at = [0]

    def peek():
        return tokens[at[0]][0] if at[0] < len(tokens) else None

    def take():
        at[0] += 1
        return tokens[at[0] - 1]

    def p_or():
        node = p_and()
        while peek() == "or":
            take()
            node = ("or", node, p_and())
        return node

    def p_and():
        node = p_unary()
        while peek() == "and":
            take()
            node = ("and", node, p_unary())
        return node

    def p_unary():
        if peek() == "not":
            take()
            return ("not", p_unary())
        kind, value = take()
        if kind == "(":
            node = p_or()
            take()
            return node
        if kind == "call":
            return ("call", value)
        return ("lit", value == "true")

    node = p_or()
    if at[0] != len(tokens):
        raise ValueError(f"trailing tokens in {text!r}")
    return node


def eval_group(node: Any, allowed: Callable[[str], bool], evaluated: list) -> bool:
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "call":
        if node[1] not in evaluated:
            evaluated.append(node[1])
        return allowed(node[1])
    if kind == "not":
        return not eval_group(node[1], allowed, evaluated)
    if kind == "and":
        return eval_group(node[1], allowed, evaluated) and eval_group(node[2], allowed, evaluated)
    return eval_group(node[1], allowed, evaluated) or eval_group(node[2], allowed, evaluated)


# -- policies ----------------------------------------------------------------


class Policy:
    def __init__(self, spec: dict, controls: frozenset = frozenset()):
        module = spec["module"]
        family = module.split("://", 1)[1]
        settings = spec.get("settings") or {}
        if family == "verify-image-signatures":
            self.rules, self.mutator = verify_image_signatures(
                settings, "skip_signatures" in controls)
        else:
            self.rules, self.mutator = FAMILIES[family](settings)
        if "drop_patches" in controls:
            self.mutator = None
        self.monitor = spec.get("policyMode", "protect") == "monitor"
        self.allowed_to_mutate = bool(spec.get("allowedToMutate", False))

    def raw(self, p: Payload) -> tuple[bool, str | None, list | None]:
        """(allowed, message, patch) before the mode applies."""
        for holds, message in self.rules:
            if holds(p):
                return False, message(p), None
        return True, None, self.mutator(p) if self.mutator else None


class Reference:
    """Answers ``/validate/{policy_id}`` for one policies mapping (as
    served: signature placeholders already replaced). ``controls`` breaks
    named guarantees, for the control runs: ``skip_signatures`` trusts an
    image's glob without its signature, ``drop_patches`` answers mutating
    policies without their patch."""

    def __init__(self, policies: dict, controls: frozenset = frozenset()):
        self.entries: dict[str, Any] = {}
        for name, spec in policies.items():
            if "expression" in spec:
                members = {m: Policy(s, controls) for m, s in spec["policies"].items()}
                self.entries[name] = (parse_expression(spec["expression"]), members, spec["message"])
            else:
                self.entries[name] = Policy(spec, controls)

    def answer(self, policy_id: str, review: dict) -> dict:
        """The AdmissionResponse as a dict, with ``patch`` decoded to its
        JSON operations (compare with ``normalize``)."""
        p = review["request"]
        uid = p.get("uid", "")
        entry = self.entries[policy_id]
        if isinstance(entry, Policy):
            allowed, message, patch = entry.raw(p)
            if entry.monitor:
                return {"uid": uid, "allowed": True}
            if not allowed:
                return {"uid": uid, "allowed": False, "status": {"message": message, "code": 400}}
            if patch is not None and not entry.allowed_to_mutate:
                return {"uid": uid, "allowed": False, "status": {"message": (
                    f"Request rejected by policy {policy_id}. The policy attempted to "
                    "mutate the request, but it is currently configured to not allow "
                    "mutations.")}}
            out: dict = {"uid": uid, "allowed": True}
            if patch is not None:
                out["patchType"] = "JSONPatch"
                out["patch"] = patch
            return out
        ast, members, group_message = entry
        raws = {}

        def member_allowed(name: str) -> bool:
            if name not in raws:
                raws[name] = members[name].raw(p)
            return raws[name][0]

        evaluated: list = []
        verdict = eval_group(ast, member_allowed, evaluated)
        for name in members:
            if name in evaluated and raws[name][0] and raws[name][2]:
                return {"uid": uid, "allowed": False,
                        "status": {"message": GROUP_MUTATION_MESSAGE, "code": 500}}
        if verdict:
            return {"uid": uid, "allowed": True}
        causes = [
            {"field": f"spec.policies.{name}", "message": raws[name][1]}
            for name in members if name in evaluated and not raws[name][0]
        ]
        return {"uid": uid, "allowed": False, "status": {
            "message": group_message, "code": 400, "details": {"causes": causes}}}


def normalize(response: dict) -> dict:
    """A served AdmissionResponse with its base64 ``patch`` decoded, so that
    two answers compare as data and not as JSON spellings."""
    out = dict(response)
    if isinstance(out.get("patch"), str):
        out["patch"] = json.loads(base64.b64decode(out["patch"]))
    return out
