"""Seeded Pod AdmissionReviews and the stream of object writes a mix sends.

``synthetic_review`` is a frozen copy of the port's flagship firehose
generator (``policies/flagship.py``): the same draws in the same order, so
its distribution cannot move when the program changes. ``pss_fields`` adds
the Pod Security fields that generator never sets, from an RNG stream of its
own, so the base distribution stays exactly that of the copy.

An object write is addressed by (seed, writer, index): the same triple gives
the same bytes in every process, which is what lets the client processes
generate their writes and the reference regenerate them after the window.
"""

from __future__ import annotations

import json
import random
from typing import Any

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

# the images the signature fixture signs; docker.io/library/redis:latest
# matches a signature glob and stays unsigned, so the fail-closed path runs
SIGNED_IMAGES = (
    "registry.prod.example.com/api/server:v1.4.2",
    "registry.prod.example.com/web/frontend:2024.1",
    "docker.io/library/nginx:1.25",
)


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


# sysctls: the Pod Security Standards' safe set and a few that are not
SAFE_SYSCTLS = (
    "kernel.shm_rmid_forced",
    "net.ipv4.ip_local_port_range",
    "net.ipv4.ip_unprivileged_port_start",
    "net.ipv4.tcp_syncookies",
    "net.ipv4.ping_group_range",
)
UNSAFE_SYSCTLS = ("kernel.msgmax", "net.core.somaxconn", "vm.swappiness")


def pss_fields(review: dict[str, Any], rng: random.Random, rate: float) -> None:
    """Set, each with probability ``rate`` per container (per Pod for
    ``sysctls``, which the API has only at Pod level), the Pod Security
    fields ``synthetic_review`` never sets: ``procMount``,
    ``seLinuxOptions``, ``runAsUser`` and ``sysctls``. Half of each draw
    is a value the Restricted profile allows, half one it forbids."""
    if rate <= 0:
        return
    spec = review["request"]["object"]["spec"]
    for container in spec["containers"]:
        draws = [rng.random() < rate for _ in range(3)]
        if not any(draws):
            continue
        sc = container.setdefault("securityContext", {})
        if draws[0]:
            sc["procMount"] = rng.choice(["Default", "Unmasked"])
        if draws[1]:
            sc["seLinuxOptions"] = {"type": rng.choice(["container_t", "spc_t"])}
        if draws[2]:
            sc["runAsUser"] = rng.choice([0, 1000])
    if rng.random() < rate:
        spec["securityContext"] = {
            "sysctls": [
                {"name": rng.choice(SAFE_SYSCTLS + UNSAFE_SYSCTLS), "value": "1"}
            ]
        }


def object_uid(writer: int, index: int) -> int:
    """A write's uid number: distinct for every (writer, index) of a run."""
    return writer * 10_000_000 + index


def object_review(seed: int, writer: int, index: int, mix: dict) -> dict:
    """The AdmissionReview of writer ``writer``'s ``index``-th write.

    With ``replay_share`` > 0 that share of writes re-sends an earlier
    object of the same writer (one of its last ``replay_window``) as an
    ``UPDATE`` with a new request uid; the rest are new objects."""
    rng = random.Random(f"{seed}:{writer}:{index}")
    source = index
    share = float(mix.get("replay_share", 0.0))
    if share > 0 and index > 0 and rng.random() < share:
        window = int(mix.get("replay_window", 4096))
        source = max(0, index - 1 - rng.randrange(min(window, index)))
        while source > 0 and _is_replay(seed, writer, source, share):
            source -= 1
    review = synthetic_review(
        random.Random(f"{seed}:{writer}:{source}:object"), object_uid(writer, source)
    )
    pss_fields(
        review, random.Random(f"{seed}:{writer}:{source}:pss"),
        float(mix.get("pss_field_rate", 0.0)),
    )
    if source != index:
        review["request"]["uid"] = f"synthetic-{object_uid(writer, index)}"
        review["request"]["operation"] = "UPDATE"
    return review


def _is_replay(seed: int, writer: int, index: int, share: float) -> bool:
    rng = random.Random(f"{seed}:{writer}:{index}")
    return rng.random() < share


def phases(policy_ids: list[str], mutating: list[str], seed: int, writer: int,
           index: int, mix: dict) -> list[list[str]]:
    """The calls of one write, phase by phase, as the API server makes them.

    ``fanout: all``: first each mutating webhook alone, one after another
    in the order given (``mutating``, the configuration's
    ``mutating_webhooks``), then every other top-level policy at once on
    the mutated object. ``fanout: one``: a single call to one policy drawn
    from the seed."""
    if mix.get("fanout", "all") == "all":
        validating = [p for p in policy_ids if p not in mutating]
        return [[m] for m in mutating] + ([validating] if validating else [])
    rng = random.Random(f"{seed}:{writer}:{index}:target")
    return [[rng.choice(policy_ids)]]


def widest_phase(policy_ids: list[str], mutating: list[str], mix: dict) -> int:
    """The most calls one write has in flight at once."""
    return max(len(p) for p in phases(policy_ids, mutating, 0, 0, 0, mix))


def apply_patch(doc: Any, ops: list) -> Any:
    """``doc`` with a JSONPatch (RFC 6902: add, remove, replace) applied,
    as the API server applies a mutating webhook's patch; ``doc``
    and ``ops`` are left as they were."""
    doc = json.loads(json.dumps(doc))
    for op in json.loads(json.dumps(ops)):
        parts = [t.replace("~1", "/").replace("~0", "~") for t in op["path"].split("/")[1:]]
        if not parts:
            doc = op.get("value")
            continue
        parent = doc
        for t in parts[:-1]:
            parent = parent[int(t)] if isinstance(parent, list) else parent[t]
        last = parts[-1]
        kind = op["op"]
        if isinstance(parent, list):
            i = len(parent) if last == "-" else int(last)
            if kind == "add":
                parent.insert(i, op["value"])
            elif kind == "replace":
                parent[i] = op["value"]
            elif kind == "remove":
                del parent[i]
            else:
                raise ValueError(f"JSONPatch op {kind!r} is not applied here")
        elif kind in ("add", "replace"):
            if kind == "replace" and last not in parent:
                raise KeyError(op["path"])
            parent[last] = op["value"]
        elif kind == "remove":
            del parent[last]
        else:
            raise ValueError(f"JSONPatch op {kind!r} is not applied here")
    return doc


def mutated(review: dict, patch: list) -> dict:
    """The review the next webhook of the write gets: the same request
    with ``patch`` applied to its object."""
    out = dict(review)
    out["request"] = dict(review["request"], object=apply_patch(review["request"]["object"], patch))
    return out


def review_body(review: dict) -> bytes:
    return json.dumps(review, separators=(",", ":")).encode()
