"""The flagship 32-policy benchmark set and synthetic AdmissionReview
firehose (BASELINE.md config 4: "32 mixed Kubewarden policies, 100k
synthetic AdmissionReview firehose"), driven by chip_smoke.py and the
port's tests.

The mix mirrors a realistic Kubewarden install: pod-security policies,
image-provenance policies, label/annotation hygiene, quota caps, and two
policy groups with boolean expressions."""

from __future__ import annotations

import functools
import random
import tempfile
from typing import Any

from policy_server_tpu_torch.models.policy import (
    PolicyOrPolicyGroup,
    parse_policy_entry,
)


@functools.lru_cache(maxsize=1)
def _signature_fixture() -> tuple[str, str]:
    """(store_dir, pub_pem): process-local signature store for the
    verify-image-signatures entries — the provenance-relevant firehose
    images are signed with a deterministic Ed25519 key so the benchmark
    exercises the REAL verification pipeline (hook → cached crypto →
    context provider → device gate), with some images left unsigned to
    exercise the rejection path."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        NoEncryption,
        PrivateFormat,
        PublicFormat,
    )

    from policy_server_tpu_torch.policies.images import (
        sign_image,
        write_signature_bundle,
    )

    key = Ed25519PrivateKey.from_private_bytes(bytes(range(32)))
    priv_pem = key.private_bytes(
        Encoding.PEM, PrivateFormat.PKCS8, NoEncryption()
    )
    pub_pem = key.public_key().public_bytes(
        Encoding.PEM, PublicFormat.SubjectPublicKeyInfo
    ).decode()
    store = tempfile.mkdtemp(prefix="flagship-image-sigs-")
    for image in (
        "registry.prod.example.com/api/server:v1.4.2",
        "registry.prod.example.com/web/frontend:2024.1",
        "docker.io/library/nginx:1.25",
        # docker.io/library/redis:latest matches the glob but stays
        # UNSIGNED: the unverified-rejection path sees real traffic
    ):
        write_signature_bundle(store, image, sign_image(priv_pem, image))
    return store, pub_pem


def flagship_policy_specs() -> dict[str, dict[str, Any]]:
    """32 top-level entries (30 singles + 2 groups)."""
    try:
        sig_store, sig_pub = _signature_fixture()
    except ImportError:
        # fetch/verify soft-dep pattern (round 7): without the
        # cryptography module the two signature-backed entries degrade to
        # crypto-free provenance stand-ins so the 32-policy firehose (and
        # the HTTP bench built on it) still runs — loudly, because the
        # real verification pipeline is then NOT exercised.
        import logging

        logging.getLogger("kubewarden-policy-server").warning(
            "cryptography unavailable: flagship signature policies "
            "degrade to trusted-repos stand-ins (verification pipeline "
            "not exercised)"
        )
        sig_store = sig_pub = None
    specs: dict[str, dict[str, Any]] = {
        "pod-privileged": {"module": "builtin://pod-privileged"},
        "pod-privileged-monitor": {
            "module": "builtin://pod-privileged", "policyMode": "monitor",
        },
        "host-namespaces": {"module": "builtin://host-namespaces"},
        "readonly-root-fs": {"module": "builtin://readonly-root-fs"},
        "run-as-non-root": {"module": "builtin://run-as-non-root"},
        "proc-mount-types": {"module": "builtin://allowed-proc-mount-types"},
        "hostpaths": {
            "module": "builtin://hostpaths",
            "settings": {
                "allowed_host_paths": [
                    {"pathPrefix": "/var/log", "readOnly": True},
                    {"pathPrefix": "/tmp", "readOnly": False},
                ]
            },
        },
        "disallow-latest": {"module": "builtin://disallow-latest-tag"},
        "psp-apparmor": {
            "module": "builtin://psp-apparmor",
            "settings": {"allowed_profiles": ["runtime/default", "localhost/lockdown"]},
        },
        "psp-capabilities": {
            "module": "builtin://psp-capabilities",
            "allowedToMutate": True,
            "settings": {
                "allowed_capabilities": ["NET_BIND_SERVICE", "CHOWN"],
                "required_drop_capabilities": ["NET_ADMIN"],
                "default_add_capabilities": ["CHOWN"],
            },
        },
        "trusted-repos": {
            "module": "builtin://trusted-repos",
            "settings": {
                "registries": {"allow": ["registry.prod.example.com", "docker.io"]},
                "tags": {"reject": ["latest", "dev"]},
            },
        },
        "verify-signatures": {
            "module": "builtin://verify-image-signatures",
            "settings": {
                "signatures": [
                    {"image": "registry.prod.example.com/*",
                     "pubKeys": [sig_pub]},
                    {"image": "docker.io/library/*", "pubKeys": [sig_pub]},
                ],
                "signatureStore": sig_store,
            },
        } if sig_pub is not None else {
            "module": "builtin://trusted-repos",
            "settings": {
                "registries": {"allow": ["registry.prod.example.com",
                                         "docker.io"]},
            },
        },
        "raw-gate": {"module": "builtin://raw-mutation", "allowedToMutate": True},
        "replicas-max": {
            "module": "builtin://replicas-max", "settings": {"max_replicas": 10},
        },
        "baseline-canary": {"module": "builtin://always-happy"},
        "audit-unhappy": {
            "module": "builtin://always-unhappy", "policyMode": "monitor",
            "settings": {"message": "audit canary: request flagged"},
        },
    }
    # namespace fences for 8 tenants
    for i in range(8):
        specs[f"ns-fence-{i}"] = {
            "module": "builtin://namespace-validate",
            "settings": {"denied_namespaces": [f"tenant-{i}-restricted", "kube-system"]},
        }
    # label/annotation hygiene per environment
    for env_name in ("prod", "staging", "dev"):
        specs[f"labels-{env_name}"] = {
            "module": "builtin://safe-labels",
            "settings": {
                "mandatory_labels": ["owner", "cost-center"],
                "denied_labels": [f"{env_name}.example.com/legacy"],
            },
        }
        specs[f"annotations-{env_name}"] = {
            "module": "builtin://safe-annotations",
            "settings": {"denied_annotations": [f"{env_name}.example.com/debug"]},
        }
    # two policy groups (BASELINE config 3 shape: OR/AND expression tree)
    specs["image-provenance-group"] = {
        "expression": "signed() || (trusted() && not_latest())",
        "message": "image provenance cannot be established",
        "policies": {
            "signed": {
                "module": "builtin://verify-image-signatures",
                "settings": {
                    "signatures": [
                        {"image": "registry.prod.example.com/*",
                         "pubKeys": [sig_pub]},
                    ],
                    "signatureStore": sig_store,
                },
            } if sig_pub is not None else {
                "module": "builtin://trusted-repos",
                "settings": {
                    "registries": {"allow": ["registry.prod.example.com"]},
                },
            },
            "trusted": {
                "module": "builtin://trusted-repos",
                "settings": {"registries": {"allow": ["docker.io"]}},
            },
            "not_latest": {"module": "builtin://disallow-latest-tag"},
        },
    }
    specs["pod-security-group"] = {
        "expression": "unprivileged() && (nonroot() || readonly())",
        "message": "pod security baseline not met",
        "policies": {
            "unprivileged": {"module": "builtin://pod-privileged"},
            "nonroot": {"module": "builtin://run-as-non-root"},
            "readonly": {"module": "builtin://readonly-root-fs"},
        },
    }
    assert len(specs) == 32, len(specs)
    return specs


def flagship_policies() -> dict[str, PolicyOrPolicyGroup]:
    return {
        name: parse_policy_entry(name, spec)
        for name, spec in flagship_policy_specs().items()
    }


# ---------------------------------------------------------------------------
# Synthetic AdmissionReview firehose
# ---------------------------------------------------------------------------

_IMAGES = [
    "registry.prod.example.com/api/server:v1.4.2",
    "registry.prod.example.com/web/frontend:2024.1",
    "docker.io/library/nginx:1.25",
    "docker.io/library/redis:latest",
    "ghcr.io/example/tool:dev",
    "internal.example.com/batch/worker:v9",
]

_NAMESPACES = [
    "default", "prod", "staging", "team-a", "tenant-3-restricted",
    "kube-system", "payments",
]

_OPERATIONS = ["CREATE", "UPDATE", "DELETE"]


def synthetic_review(rng: random.Random, uid: int) -> dict[str, Any]:
    """One synthetic Pod AdmissionReview document (dict form)."""
    ns = rng.choice(_NAMESPACES)
    n_containers = rng.randint(1, 4)
    containers = []
    for c in range(n_containers):
        container: dict[str, Any] = {
            "name": f"c{c}",
            "image": rng.choice(_IMAGES),
        }
        sc: dict[str, Any] = {}
        if rng.random() < 0.15:
            sc["privileged"] = True
        if rng.random() < 0.5:
            sc["runAsNonRoot"] = rng.random() < 0.8
        if rng.random() < 0.4:
            sc["readOnlyRootFilesystem"] = rng.random() < 0.7
        if rng.random() < 0.2:
            sc["capabilities"] = {
                "add": rng.sample(
                    ["NET_BIND_SERVICE", "CHOWN", "SYS_ADMIN", "NET_ADMIN"],
                    rng.randint(1, 2),
                )
            }
        if sc:
            container["securityContext"] = sc
        if rng.random() < 0.3:
            container["volumeMounts"] = [
                {"name": "v0", "mountPath": rng.choice(["/var/log", "/etc", "/tmp"])}
            ]
        containers.append(container)

    labels = {"app": f"app-{uid % 17}"}
    if rng.random() < 0.7:
        labels["owner"] = "team-core"
        labels["cost-center"] = "cc-42"
    annotations = {}
    if rng.random() < 0.25:
        annotations["container.apparmor.security.beta.kubernetes.io/c0"] = (
            rng.choice(["runtime/default", "localhost/lockdown", "unconfined"])
        )
    if rng.random() < 0.1:
        annotations["prod.example.com/debug"] = "true"

    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"pod-{uid}",
            "namespace": ns,
            "labels": labels,
            "annotations": annotations,
        },
        "spec": {"containers": containers},
    }
    if rng.random() < 0.2:
        pod["spec"]["hostNetwork"] = rng.random() < 0.5
    if rng.random() < 0.15:
        pod["spec"]["volumes"] = [
            {"name": "v0", "hostPath": {"path": rng.choice(["/var/log", "/etc"])}}
        ]

    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": f"synthetic-{uid}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "requestKind": {"group": "", "version": "v1", "kind": "Pod"},
            "resource": {"group": "", "version": "v1", "resource": "pods"},
            "name": f"pod-{uid}",
            "namespace": ns,
            "operation": rng.choice(_OPERATIONS),
            "userInfo": {"username": "system:serviceaccount:ci:deployer"},
            "object": pod,
            "dryRun": False,
        },
    }


def synthetic_firehose(n: int, seed: int = 0) -> list[dict[str, Any]]:
    rng = random.Random(seed)
    return [synthetic_review(rng, i) for i in range(n)]
