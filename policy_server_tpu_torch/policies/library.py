"""The native policy library — TPU-first re-implementations of the
Kubewarden policy catalog used by the reference's configs and benchmarks
(BASELINE.md configs 1-4; reference policies.yml.example;
tests/common/mod.rs:29-105 pulls pod-privileged, raw-mutation,
sleeping-policy from ghcr.io).

Each family is a ``BuiltinPolicy``: settings (validated at boot) → a
``PolicyProgram`` of deny rules in the predicate IR, all of which fuse into
the batched device program. Mutating families attach host-side JSONPatch
mutators (device decides the verdict; host materializes patches —
SURVEY.md §7.4 hard-part #3).

Payload root is the AdmissionRequest object (uid/namespace/operation/object),
matching what the reference hands to WASM guests.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Mapping

from policy_server_tpu_torch.ops.compiler import PolicyProgram, Rule
from policy_server_tpu_torch.ops.ir import (
    AllOf,
    AnyOf,
    DType,
    Elem,
    Exists,
    Expr,
    Or,
    Path,
    StrPred,
    eq,
    false,
    ge,
    gt,
    in_set,
    le,
    matches_glob,
    ne,
    true,
)
from policy_server_tpu_torch.policies.base import (
    BuiltinPolicy,
    SettingsError,
    bool_setting,
    number_setting,
    str_list,
)

NAMESPACE = Path("namespace")
OPERATION = Path("operation")

# Pod-spec container lists (validated for Pods; container-level rules apply
# to every list, like the upstream policies do).
CONTAINER_LISTS = (
    Path("object.spec.containers"),
    Path("object.spec.initContainers"),
    Path("object.spec.ephemeralContainers"),
)


def _deny_any_container(pred: Expr) -> Expr:
    """∃ a container (in any of the three lists) matching pred."""
    return Or(tuple(AnyOf(lst, pred) for lst in CONTAINER_LISTS))


def _image_matches_none(patterns: list[str]) -> Expr:
    """Container-scoped: its image matches none of the glob patterns
    (missing image also matches none)."""
    if not patterns:
        return true()
    return ~Or(tuple(matches_glob(Elem("image"), p) for p in patterns))


# ---------------------------------------------------------------------------


class AlwaysHappy(BuiltinPolicy):
    """Accepts everything — the engine-test fixture, standing in for the
    reference's embedded gatekeeper_always_happy_policy.wasm
    (evaluation_environment.rs:727-731)."""

    name = "always-happy"

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        return PolicyProgram(rules=(Rule("never", false(), "unreachable"),))


class AlwaysUnhappy(BuiltinPolicy):
    """Rejects everything (gatekeeper_always_unhappy_policy.wasm analog).
    The rejection message is settings-configurable like the fixture's."""

    name = "always-unhappy"

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        message = settings.get("message", "this policy always rejects")
        if not isinstance(message, str):
            raise SettingsError("setting 'message' must be a string")
        return PolicyProgram(rules=(Rule("always", true(), message),))


class Sleeping(BuiltinPolicy):
    """Latency-fault fixture: sleeps ``sleep_ms`` host-side before building
    features — the analog of the reference's sleeping-policy used for
    timeout-protection tests (tests/integration_test.rs:367-423)."""

    name = "sleeping"
    upstream_equivalents = ("ghcr.io/kubewarden/tests/sleeping-policy",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        sleep_ms = number_setting(settings, "sleep_ms", 0.0)
        if sleep_ms < 0:
            raise SettingsError("setting 'sleep_ms' must be >= 0")

        def hook(payload: Any) -> None:
            time.sleep(sleep_ms / 1000.0)

        return PolicyProgram(
            rules=(Rule("never", false(), "unreachable"),),
            pre_eval_hook=hook,
        )


class NamespaceValidate(BuiltinPolicy):
    """Reject requests targeting denied namespaces (BASELINE.md config 1:
    namespace-validate-policy)."""

    name = "namespace-validate"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/namespace-validate-policy",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        denied = str_list(settings, "denied_namespaces")
        if not denied:
            raise SettingsError("setting 'denied_namespaces' must be a non-empty list")
        return PolicyProgram(
            rules=(
                Rule(
                    "denied-namespace",
                    in_set(NAMESPACE, denied),
                    lambda payload: (
                        f"namespace '{_get(payload, 'namespace')}' is denied"
                    ),
                ),
            )
        )


class PodPrivileged(BuiltinPolicy):
    """Reject privileged containers (upstream pod-privileged, used by the
    reference integration tests, tests/common/mod.rs:33-38)."""

    name = "pod-privileged"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/pod-privileged",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        if settings:
            raise SettingsError("pod-privileged accepts no settings")
        privileged = eq(Elem("securityContext.privileged", DType.BOOL), True)
        return PolicyProgram(
            rules=(
                Rule(
                    "privileged-container",
                    _deny_any_container(privileged),
                    "Privileged container is not allowed",
                ),
            )
        )


class PspCapabilities(BuiltinPolicy):
    """Capability control + mutation (upstream psp-capabilities; the
    reference's policies.yml.example entry). Settings:
    allowed_capabilities (["*"] = any), required_drop_capabilities,
    default_add_capabilities. Mutating: ensures required drops / default
    adds are present via host-side JSONPatch."""

    name = "psp-capabilities"
    mutating = True
    upstream_equivalents = ("ghcr.io/kubewarden/policies/psp-capabilities",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        allowed = str_list(settings, "allowed_capabilities")
        required_drop = str_list(settings, "required_drop_capabilities")
        default_add = str_list(settings, "default_add_capabilities")
        for cap in default_add:
            if allowed != ["*"] and cap not in allowed:
                raise SettingsError(
                    f"default_add_capabilities entry {cap!r} is not in allowed_capabilities"
                )

        rules = []
        if "*" not in allowed:
            rules.append(
                Rule(
                    "capability-not-allowed",
                    _deny_any_container(
                        AnyOf(
                            Elem("securityContext.capabilities.add"),
                            ~in_set(Elem(), allowed) if allowed else true(),
                        )
                    ),
                    "PSP capabilities policies doesn't allow these capabilities to be added",
                )
            )
        if not rules:
            rules.append(Rule("never", false(), "unreachable"))

        def mutator(payload: Any) -> list[dict] | None:
            return _psp_capabilities_patch(payload, required_drop, default_add)

        return PolicyProgram(rules=tuple(rules), mutator=mutator)


def _psp_capabilities_patch(
    payload: Any, required_drop: list[str], default_add: list[str]
) -> list[dict] | None:
    """JSONPatch ensuring each container drops required caps and adds the
    default ones. Host-side by design (patches don't batch)."""
    if not required_drop and not default_add:
        return None
    ops: list[dict] = []
    spec = _get(payload, "object", "spec") or {}
    for list_name in ("containers", "initContainers", "ephemeralContainers"):
        containers = spec.get(list_name)
        if not isinstance(containers, list):
            continue
        for i, c in enumerate(containers):
            if not isinstance(c, Mapping):
                continue
            base = f"/spec/{list_name}/{i}/securityContext"
            sc = c.get("securityContext")
            caps = sc.get("capabilities") if isinstance(sc, Mapping) else None
            cur_drop = list(caps.get("drop") or []) if isinstance(caps, Mapping) else []
            cur_add = list(caps.get("add") or []) if isinstance(caps, Mapping) else []
            new_drop = cur_drop + [c_ for c_ in required_drop if c_ not in cur_drop]
            new_add = cur_add + [c_ for c_ in default_add if c_ not in cur_add]
            if new_drop == cur_drop and new_add == cur_add:
                continue
            if not isinstance(sc, Mapping):
                ops.append({"op": "add", "path": base, "value": {}})
            if not isinstance(caps, Mapping):
                ops.append({"op": "add", "path": f"{base}/capabilities", "value": {}})
            if new_drop != cur_drop:
                ops.append(
                    {"op": "add", "path": f"{base}/capabilities/drop", "value": new_drop}
                )
            if new_add != cur_add:
                ops.append(
                    {"op": "add", "path": f"{base}/capabilities/add", "value": new_add}
                )
    # object path prefix: patches apply to the object, not the request
    return ops or None


class PspApparmor(BuiltinPolicy):
    """AppArmor profile allowlist (upstream psp-apparmor; the reference's
    policies.yml.example first entry). Checks pod annotations
    ``container.apparmor.security.beta.kubernetes.io/<container>``."""

    name = "psp-apparmor"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/psp-apparmor",)

    _PREFIX = "container.apparmor.security.beta.kubernetes.io/"

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        allowed = str_list(settings, "allowed_profiles", ["runtime/default"])
        annotations = Path("object.metadata.annotations")
        bad = AnyOf(
            annotations,
            StrPred(Elem("__key__"), "prefix", self._PREFIX)
            & ~in_set(Elem("__value__"), allowed),
        )
        return PolicyProgram(
            rules=(
                Rule(
                    "apparmor-profile-not-allowed",
                    bad,
                    "These AppArmor profiles are not allowed: not in the allowed list",
                ),
            )
        )


class TrustedRepos(BuiltinPolicy):
    """Registry/tag allow-reject lists (upstream trusted-repos-policy; the
    ``reject_latest_tag`` member of the reference's example policy group).
    Settings: registries.allow/reject, tags.reject, images.allow/reject."""

    name = "trusted-repos"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/trusted-repos-policy",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        registries = settings.get("registries") or {}
        tags = settings.get("tags") or {}
        images = settings.get("images") or {}
        if not isinstance(registries, Mapping) or not isinstance(tags, Mapping) or not isinstance(images, Mapping):
            raise SettingsError("registries/tags/images settings must be mappings")
        reg_allow = str_list(registries, "allow")
        reg_reject = str_list(registries, "reject")
        tag_reject = str_list(tags, "reject")
        img_allow = str_list(images, "allow")
        img_reject = str_list(images, "reject")

        image = Elem("image")
        rules: list[Rule] = []
        if reg_allow:
            rules.append(
                Rule(
                    "registry-not-allowed",
                    _deny_any_container(
                        ~Or(tuple(StrPred(image, "prefix", r.rstrip("/") + "/") for r in reg_allow))
                    ),
                    "not coming from an allowed registry",
                )
            )
        if reg_reject:
            rules.append(
                Rule(
                    "registry-rejected",
                    _deny_any_container(
                        Or(tuple(StrPred(image, "prefix", r.rstrip("/") + "/") for r in reg_reject))
                    ),
                    "coming from a rejected registry",
                )
            )
        for t in tag_reject:
            rules.append(
                Rule(
                    f"tag-rejected-{t}",
                    _deny_any_container(StrPred(image, "suffix", f":{t}")),
                    f"tag '{t}' is rejected",
                )
            )
        if img_allow:
            rules.append(
                Rule(
                    "image-not-allowed",
                    _deny_any_container(_image_matches_none(img_allow)),
                    "image is not in the allowed list",
                )
            )
        for pattern in img_reject:
            rules.append(
                Rule(
                    f"image-rejected-{pattern}",
                    _deny_any_container(matches_glob(image, pattern)),
                    f"image matches rejected pattern '{pattern}'",
                )
            )
        if not rules:
            raise SettingsError(
                "trusted-repos requires at least one of registries/tags/images rules"
            )
        return PolicyProgram(rules=tuple(rules))


class VerifyImageSignatures(BuiltinPolicy):
    """Image-signature policy (upstream verify-image-signatures; the
    ``sigstore_pgp`` / ``sigstore_gh_action`` members of the reference's
    example group). Settings: ``signatures: [{image: <glob>, pubKeys:
    [<PEM>...], annotations?: {...}}]``, plus the hermetic ``signatureStore``
    directory (see policies/images.py for the transport).

    TPU-native split (SURVEY.md §2.2 callback_handler/sigstore rows): the
    device keeps the glob pre-filter batched; REAL Ed25519 verification of
    matched images runs host-side in the pre-eval hook (cached per image
    ref, bounded by the request deadline), and a context provider feeds the
    cached result count to the device program — so a
    matching-glob-but-unsigned image is rejected, unlike a pure glob
    filter. Keyless entry kinds (githubActions / keyless certificates)
    need Fulcio/Rekor egress and FAIL settings validation loudly."""

    name = "verify-image-signatures"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/verify-image-signatures",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        from policy_server_tpu_torch.policies.images import (
            ImageSignatureVerifier,
            SignatureEntry,
            extract_container_images,
            file_bundle_source,
        )

        signatures = settings.get("signatures")
        if not isinstance(signatures, list) or not signatures:
            raise SettingsError("setting 'signatures' must be a non-empty list")
        entries: list[SignatureEntry] = []
        for s in signatures:
            if not isinstance(s, Mapping) or not isinstance(s.get("image"), str):
                raise SettingsError("each signatures entry must have an 'image' glob")
            if any(k in s for k in ("githubActions", "keylessPrefix", "keyless")):
                raise SettingsError(
                    "signature entry kind requires sigstore keyless "
                    "verification (Fulcio/Rekor egress), which this build "
                    "does not support"
                )
            pub_keys = s.get("pubKeys")
            if not isinstance(pub_keys, list) or not all(
                isinstance(k, str) for k in pub_keys
            ) or not pub_keys:
                raise SettingsError(
                    "each signatures entry must have a non-empty 'pubKeys' "
                    "list of PEM Ed25519 public keys"
                )
            annotations = s.get("annotations") or {}
            if not isinstance(annotations, Mapping):
                raise SettingsError("signatures entry 'annotations' must be a map")
            entries.append(
                SignatureEntry(
                    image_glob=s["image"],
                    pub_keys=tuple(pub_keys),
                    annotations=dict(annotations),
                )
            )
        store = settings.get("signatureStore")
        if store is not None and not isinstance(store, str):
            raise SettingsError("setting 'signatureStore' must be a directory path")
        verifier = ImageSignatureVerifier(
            entries, file_bundle_source(store) if store else None
        )
        patterns = [e.image_glob for e in entries]
        # Unique per distinct settings: two group members with different
        # keys (the reference's sigstore_pgp/sigstore_gh_action example)
        # must not share one context slot.
        digest = hashlib.sha256(
            repr([(e.image_glob, e.pub_keys, sorted(e.annotations.items()))
                  for e in entries]).encode()
        ).hexdigest()[:8]
        # dot-free: IR paths split segments on '.', context keys must be
        # single segments (same convention as "v1/Namespace")
        ctx_key = f"kubewarden-io/ImageVerification-{digest}"

        def hook(payload: Any) -> None:
            verifier.ensure(extract_container_images(payload))

        # Warm-path escape hatch for the batcher's hook-deadline machinery:
        # when every image is already cached the hook would do no blocking
        # work, so no hook thread is needed (steady-state = dict lookups).
        hook.skip_if = lambda payload: verifier.all_cached(  # type: ignore[attr-defined]
            extract_container_images(payload)
        )

        def provider(payload: Any) -> Mapping[str, Any]:
            images = extract_container_images(payload)
            return {ctx_key: {"unverified_count": len(verifier.unverified(images))}}

        def unverified_message(payload: Any) -> str:
            bad = verifier.unverified(extract_container_images(payload))
            return (
                "image signature verification failed for: "
                + ", ".join(f"'{i}'" for i in bad)
            )

        return PolicyProgram(
            rules=(
                Rule(
                    "unmatched-image",
                    _deny_any_container(
                        Exists(Elem("image")) & _image_matches_none(patterns)
                    ),
                    "image signature verification failed: image matches no "
                    "signature entry",
                ),
                Rule(
                    "unverified-image",
                    gt(
                        Path(
                            f"__context__.{ctx_key}.unverified_count",
                            DType.I32,
                        ),
                        0,
                    ),
                    unverified_message,
                ),
            ),
            pre_eval_hook=hook,
            context_provider=provider,
        )


class DisallowLatestTag(BuiltinPolicy):
    """Reject images with no tag or the ``latest`` tag (Gatekeeper
    disallowed-tags family)."""

    name = "disallow-latest-tag"

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        if settings:
            raise SettingsError("disallow-latest-tag accepts no settings")
        image = Elem("image")
        # tagged-or-digested: a ':' after the last '/': regex on full string.
        untagged = ~StrPred(image, "regex", r"^(?:[^/]*/)*[^/]*[:@][^/]*$")
        latest = StrPred(image, "suffix", ":latest")
        return PolicyProgram(
            rules=(
                Rule(
                    "latest-tag",
                    _deny_any_container(Exists(Elem("image")) & (untagged | latest)),
                    "images must have an explicit, non-latest tag",
                ),
            )
        )


class HostNamespaces(BuiltinPolicy):
    """Control hostNetwork/hostPID/hostIPC usage (upstream
    host-namespaces-psp)."""

    name = "host-namespaces"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/host-namespaces-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        rules = []
        for key, flag in (
            ("allow_host_network", "hostNetwork"),
            ("allow_host_pid", "hostPID"),
            ("allow_host_ipc", "hostIPC"),
        ):
            if not bool_setting(settings, key, False):
                rules.append(
                    Rule(
                        f"{flag}-not-allowed",
                        eq(Path(f"object.spec.{flag}", DType.BOOL), True),
                        f"Pod has {flag} enabled, but this is not allowed",
                    )
                )
        if not rules:
            rules.append(Rule("never", false(), "unreachable"))
        return PolicyProgram(rules=tuple(rules))


class ReadOnlyRootFilesystem(BuiltinPolicy):
    """Containers must run with a read-only root filesystem (upstream
    readonly-root-filesystem-psp)."""

    name = "readonly-root-fs"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/readonly-root-filesystem-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        if settings:
            raise SettingsError("readonly-root-fs accepts no settings")
        ok = eq(Elem("securityContext.readOnlyRootFilesystem", DType.BOOL), True)
        return PolicyProgram(
            rules=(
                Rule(
                    "writable-root-fs",
                    _deny_any_container(~ok),
                    "containers must set securityContext.readOnlyRootFilesystem to true",
                ),
            )
        )


class SafeLabels(BuiltinPolicy):
    """Mandatory / denied labels (upstream safe-labels). Settings:
    mandatory_labels, denied_labels."""

    name = "safe-labels"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/safe-labels",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        mandatory = str_list(settings, "mandatory_labels")
        denied = str_list(settings, "denied_labels")
        if not mandatory and not denied:
            raise SettingsError(
                "safe-labels requires mandatory_labels and/or denied_labels"
            )
        labels = Path("object.metadata.labels")
        rules: list[Rule] = []
        for lbl in mandatory:
            rules.append(
                Rule(
                    f"missing-label-{lbl}",
                    ~Exists(Path(("object", "metadata", "labels", lbl))),
                    f"mandatory label {lbl!r} is missing",
                )
            )
        if denied:
            rules.append(
                Rule(
                    "denied-label",
                    AnyOf(labels, in_set(Elem("__key__"), denied)),
                    "a denied label is present",
                )
            )
        return PolicyProgram(rules=tuple(rules))


class SafeAnnotations(BuiltinPolicy):
    """Mandatory / denied annotations (upstream safe-annotations)."""

    name = "safe-annotations"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/safe-annotations",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        mandatory = str_list(settings, "mandatory_annotations")
        denied = str_list(settings, "denied_annotations")
        if not mandatory and not denied:
            raise SettingsError(
                "safe-annotations requires mandatory_annotations and/or denied_annotations"
            )
        annotations = Path("object.metadata.annotations")
        rules: list[Rule] = []
        for ann in mandatory:
            rules.append(
                Rule(
                    f"missing-annotation-{ann}",
                    ~Exists(Path(("object", "metadata", "annotations", ann))),
                    f"mandatory annotation {ann!r} is missing",
                )
            )
        if denied:
            rules.append(
                Rule(
                    "denied-annotation",
                    AnyOf(annotations, in_set(Elem("__key__"), denied)),
                    "a denied annotation is present",
                )
            )
        return PolicyProgram(rules=tuple(rules))


class ReplicasMax(BuiltinPolicy):
    """Cap replica counts on scalable resources."""

    name = "replicas-max"

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        max_replicas = number_setting(settings, "max_replicas")
        return PolicyProgram(
            rules=(
                Rule(
                    "too-many-replicas",
                    gt(Path("object.spec.replicas", DType.F32), max_replicas),
                    f"spec.replicas must not exceed {int(max_replicas)}",
                ),
            )
        )


class RunAsNonRoot(BuiltinPolicy):
    """Pods must not run as root (upstream user-group-psp simplified:
    requires runAsNonRoot=true at pod or container level)."""

    name = "run-as-non-root"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/user-group-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        pod_ok = eq(Path("object.spec.securityContext.runAsNonRoot", DType.BOOL), True)
        container_ok = eq(Elem("securityContext.runAsNonRoot", DType.BOOL), True)
        return PolicyProgram(
            rules=(
                Rule(
                    "may-run-as-root",
                    ~pod_ok & _deny_any_container(~container_ok),
                    "pods must set runAsNonRoot at pod or container level",
                ),
            )
        )


class AllowedProcMountTypes(BuiltinPolicy):
    """Restrict procMount types (upstream allowed-proc-mount-types-psp)."""

    name = "allowed-proc-mount-types"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/allowed-proc-mount-types-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        allowed = str_list(settings, "allowed_types", ["Default"])
        bad = Exists(Elem("securityContext.procMount")) & ~in_set(
            Elem("securityContext.procMount"), allowed
        )
        return PolicyProgram(
            rules=(
                Rule(
                    "proc-mount-not-allowed",
                    _deny_any_container(bad),
                    f"procMount must be one of {allowed}",
                ),
            )
        )


class HostPaths(BuiltinPolicy):
    """Restrict hostPath volumes (upstream hostpaths-psp). Settings:
    allowed_host_paths: [{pathPrefix, readOnly?}] — absent list denies all
    hostPath volumes."""

    name = "hostpaths"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/hostpaths-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        allowed = settings.get("allowed_host_paths") or []
        if not isinstance(allowed, list):
            raise SettingsError("allowed_host_paths must be a list")
        prefixes: list[str] = []
        for entry in allowed:
            if not isinstance(entry, Mapping) or not isinstance(entry.get("pathPrefix"), str):
                raise SettingsError("allowed_host_paths entries need a pathPrefix")
            prefixes.append(entry["pathPrefix"])
        volumes = Path("object.spec.volumes")
        is_hostpath = Exists(Elem("hostPath.path"))
        if prefixes:
            ok = Or(tuple(StrPred(Elem("hostPath.path"), "prefix", p) for p in prefixes))
            bad = is_hostpath & ~ok
        else:
            bad = is_hostpath
        return PolicyProgram(
            rules=(
                Rule(
                    "hostpath-not-allowed",
                    AnyOf(volumes, bad),
                    "hostPath volume is not allowed",
                ),
            )
        )


class EchoOperation(BuiltinPolicy):
    """Raw-request policy: rejects raw documents whose ``forbidden`` field is
    true — exercises /validate_raw the way the reference uses its
    raw-mutation policy (tests/common/mod.rs:40-47). Mutating: adds a
    ``validated: true`` field via JSONPatch when allowed."""

    name = "raw-mutation"
    mutating = True
    upstream_equivalents = ("ghcr.io/kubewarden/tests/raw-mutation-policy",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        def mutator(payload: Any) -> list[dict] | None:
            if isinstance(payload, Mapping) and "validated" not in payload:
                return [{"op": "add", "path": "/validated", "value": True}]
            return None

        return PolicyProgram(
            rules=(
                Rule(
                    "forbidden",
                    eq(Path("forbidden", DType.BOOL), True),
                    "the request is forbidden",
                ),
            ),
            mutator=mutator,
        )


def _get(payload: Any, *keys: str) -> Any:
    cur = payload
    for k in keys:
        if not isinstance(cur, Mapping):
            return None
        cur = cur.get(k)
    return cur


class NamespaceExists(BuiltinPolicy):
    """Context-aware policy: the request's namespace must exist in the
    cluster snapshot (the TPU-native shape of the reference's context-aware
    policies — data arrives via the ``__context__`` snapshot injected per
    the policy's contextAwareResources allowlist, SURVEY.md §2.2
    callback_handler row). Requires ``contextAwareResources: [{apiVersion:
    v1, kind: Namespace}]`` in policies.yml; without the capability the
    snapshot slice is empty and every namespaced request is rejected
    (fail-closed, like a reference policy whose kube calls are denied)."""

    name = "namespace-exists"

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        known = AnyOf(
            Path("__context__.v1/Namespace"),
            eq(Elem("metadata.name"), Path("namespace")),
        )
        return PolicyProgram(
            rules=(
                Rule(
                    "unknown-namespace",
                    Exists(Path("namespace")) & ~known,
                    lambda payload: (
                        f"namespace '{_get(payload, 'namespace')}' does not "
                        "exist in the cluster"
                    ),
                ),
            )
        )


class UserGroupPsp(BuiltinPolicy):
    """Constrain runAsUser / runAsGroup ids (upstream user-group-psp).

    Settings (simplified upstream schema)::

        run_as_user:  {rule: MustRunAs|MustRunAsNonRoot|RunAsAny,
                       ranges: [{min: N, max: N}, ...]}
        run_as_group: {rule: MustRunAs|RunAsAny, ranges: [...]}

    Semantics: with ``MustRunAs``, an explicitly set id (pod or container
    level) must fall inside one of the ranges; with ``MustRunAsNonRoot``
    the id must not be 0. Absent ids are left to the admission defaulting
    chain (run-as-non-root covers the must-be-set flavor)."""

    name = "user-group-psp"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/user-group-psp",)

    @staticmethod
    def _parse(settings: Mapping[str, Any], key: str) -> tuple[str, list]:
        doc = settings.get(key) or {}
        if not isinstance(doc, Mapping):
            raise SettingsError(f"setting '{key}' must be a map")
        rule = doc.get("rule", "RunAsAny")
        if rule not in ("MustRunAs", "MustRunAsNonRoot", "RunAsAny"):
            raise SettingsError(f"{key}.rule must be MustRunAs[NonRoot]/RunAsAny")
        ranges = doc.get("ranges") or []
        if rule == "MustRunAs" and not ranges:
            raise SettingsError(f"{key}.rule MustRunAs requires ranges")
        for r in ranges:
            if (
                not isinstance(r, Mapping)
                or not isinstance(r.get("min"), (int, float))
                or not isinstance(r.get("max"), (int, float))
                or isinstance(r.get("min"), bool)
                or isinstance(r.get("max"), bool)
            ):
                raise SettingsError(
                    f"each {key}.ranges entry needs numeric min and max"
                )
            if r["min"] > r["max"]:
                raise SettingsError(f"{key}.ranges entry has min > max")
        return rule, list(ranges)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        rules: list[Rule] = []
        for key, field in (("run_as_user", "runAsUser"),
                           ("run_as_group", "runAsGroup")):
            rule, ranges = self._parse(settings, key)
            if rule == "RunAsAny":
                continue
            # I32, not F32: float32 can't represent ids above 2^24 exactly
            # and a UID admitted past a range bound is a security bug; ids
            # beyond int32 (legal up to 2^32-2) overflow the encoding and
            # route to the exact host oracle via SchemaOverflow
            pod_id = Path(f"object.spec.securityContext.{field}", DType.I32)
            elem_id = Elem(f"securityContext.{field}", DType.I32)

            def out_of_ranges(operand: Expr) -> Expr:
                in_any: Expr = false()
                for r in ranges:
                    in_any = in_any | (
                        ge(operand, int(r["min"])) & le(operand, int(r["max"]))
                    )
                return ~in_any

            if rule == "MustRunAsNonRoot":
                bad_pod = Exists(pod_id) & eq(pod_id, 0)
                bad_elem = Exists(elem_id) & eq(elem_id, 0)
                message = f"{field} must not be 0 (root)"
            else:  # MustRunAs
                bad_pod = Exists(pod_id) & out_of_ranges(pod_id)
                bad_elem = Exists(elem_id) & out_of_ranges(elem_id)
                message = f"{field} is outside the allowed ranges"
            rules.append(Rule(f"{field}-pod", bad_pod, message))
            rules.append(
                Rule(f"{field}-container", _deny_any_container(bad_elem), message)
            )
        if not rules:
            rules.append(Rule("never", false(), "unreachable"))
        return PolicyProgram(rules=tuple(rules))


class SysctlPsp(BuiltinPolicy):
    """Forbid unsafe sysctls (upstream sysctl-psp). Settings:
    ``forbidden_sysctls`` (names or prefix globs like ``net.*``),
    ``allowed_unsafe_sysctls`` (exact names exempted)."""

    name = "sysctl-psp"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/sysctl-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        forbidden = str_list(settings, "forbidden_sysctls", default=[])
        allowed = str_list(settings, "allowed_unsafe_sysctls", default=[])
        if not forbidden:
            raise SettingsError(
                "setting 'forbidden_sysctls' must be a non-empty list"
            )
        name = Elem("name")
        hit: Expr = false()
        for pattern in forbidden:
            hit = hit | matches_glob(name, pattern)
        if allowed:
            hit = hit & ~in_set(name, allowed)
        return PolicyProgram(
            rules=(
                Rule(
                    "forbidden-sysctl",
                    AnyOf(
                        Path("object.spec.securityContext.sysctls"),
                        Exists(name) & hit,
                    ),
                    "pod sets a forbidden sysctl",
                ),
            )
        )


class ContainersResourceLimits(BuiltinPolicy):
    """Every container must declare cpu and memory limits (upstream
    containers-resource-limits presence semantics)."""

    name = "containers-resource-limits"
    upstream_equivalents = (
        "ghcr.io/kubewarden/policies/containers-resource-limits",
    )

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        if settings and set(settings) - {"require_cpu", "require_memory"}:
            raise SettingsError(
                "containers-resource-limits accepts require_cpu/require_memory"
            )
        rules = []
        if bool_setting(settings, "require_cpu", True):
            rules.append(
                Rule(
                    "missing-cpu-limit",
                    _deny_any_container(~Exists(Elem("resources.limits.cpu"))),
                    "every container must declare a cpu limit",
                )
            )
        if bool_setting(settings, "require_memory", True):
            rules.append(
                Rule(
                    "missing-memory-limit",
                    _deny_any_container(
                        ~Exists(Elem("resources.limits.memory"))
                    ),
                    "every container must declare a memory limit",
                )
            )
        if not rules:
            rules.append(Rule("never", false(), "unreachable"))
        return PolicyProgram(rules=tuple(rules))


class EnvironmentVariablePolicy(BuiltinPolicy):
    """Deny containers that set named environment variables (upstream
    environment-variable-policy, the deny-list rule). Settings:
    ``denied_names`` (exact env var names)."""

    name = "environment-variable-policy"
    upstream_equivalents = (
        "ghcr.io/kubewarden/policies/environment-variable-policy",
    )

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        denied = str_list(settings, "denied_names")
        if not denied:
            raise SettingsError("setting 'denied_names' must be a non-empty list")
        # nested quantifier: any container with any env entry whose name
        # is denied (containers[*].env[*])
        has_denied_env = AnyOf(Elem("env"), in_set(Elem("name"), denied))
        return PolicyProgram(
            rules=(
                Rule(
                    "denied-env-var",
                    _deny_any_container(has_denied_env),
                    f"containers must not set: {', '.join(sorted(denied))}",
                ),
            )
        )


class SelinuxPsp(BuiltinPolicy):
    """Constrain seLinuxOptions (upstream selinux-psp). Settings:
    ``rule: MustRunAs|RunAsAny`` with the expected ``level``/``role``/
    ``type``/``user`` values for MustRunAs: any explicitly-set field that
    differs from the expectation rejects (pod and container level)."""

    name = "selinux-psp"
    upstream_equivalents = ("ghcr.io/kubewarden/policies/selinux-psp",)

    def build(self, settings: Mapping[str, Any]) -> PolicyProgram:
        rule = settings.get("rule", "RunAsAny")
        if rule not in ("MustRunAs", "RunAsAny"):
            raise SettingsError("setting 'rule' must be MustRunAs or RunAsAny")
        if rule == "RunAsAny":
            if set(settings) - {"rule"}:
                raise SettingsError("RunAsAny accepts no field expectations")
            return PolicyProgram(
                rules=(Rule("never", false(), "unreachable"),)
            )
        fields = {
            k: settings[k]
            for k in ("level", "role", "type", "user")
            if k in settings
        }
        if not fields:
            raise SettingsError("MustRunAs requires at least one expected field")
        rules = []
        for field, expected in fields.items():
            if not isinstance(expected, str):
                raise SettingsError(f"setting '{field}' must be a string")
            pod = Path(f"object.spec.securityContext.seLinuxOptions.{field}")
            elem = Elem(f"securityContext.seLinuxOptions.{field}")
            rules.append(
                Rule(
                    f"selinux-{field}-pod",
                    Exists(pod) & ne(pod, expected),
                    f"seLinuxOptions.{field} must be '{expected}'",
                )
            )
            rules.append(
                Rule(
                    f"selinux-{field}-container",
                    _deny_any_container(Exists(elem) & ne(elem, expected)),
                    f"seLinuxOptions.{field} must be '{expected}'",
                )
            )
        return PolicyProgram(rules=tuple(rules))


ALL_FAMILIES: tuple[type[BuiltinPolicy], ...] = (
    NamespaceExists,
    AlwaysHappy,
    AlwaysUnhappy,
    Sleeping,
    NamespaceValidate,
    PodPrivileged,
    PspCapabilities,
    PspApparmor,
    TrustedRepos,
    VerifyImageSignatures,
    DisallowLatestTag,
    HostNamespaces,
    ReadOnlyRootFilesystem,
    SafeLabels,
    SafeAnnotations,
    ReplicasMax,
    RunAsNonRoot,
    AllowedProcMountTypes,
    HostPaths,
    EchoOperation,
    UserGroupPsp,
    SysctlPsp,
    ContainersResourceLimits,
    EnvironmentVariablePolicy,
    SelinuxPsp,
)
