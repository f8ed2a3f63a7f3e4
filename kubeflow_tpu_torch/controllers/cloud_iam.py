"""Cloud-IAM profile plugins: workload identity (GCP) and IAM for
ServiceAccounts (AWS).

Counterpart of `kubeflow_tpu/controllers/cloud_iam.py`, whole, its
imports pointed at the port. They are the reference's two profile
plugins, the credential plumbing that gives a tenant namespace's pods a
cloud-API identity:

- `profile-controller/controllers/plugin_workload_identity.go:44-160`:
  annotate the namespace's `default-editor` KSA with the GCP service
  account, and grant `roles/iam.workloadIdentityUser` on that GSA to the
  member `serviceAccount:<project>.svc.id.goog[<ns>/<ksa>]`.
- `profile-controller/controllers/plugin_iam.go:32-238`: annotate the KSA
  with the IAM role ARN, and add `system:serviceaccount:<ns>:<name>` to
  the role's OIDC trust policy (`sts:AssumeRoleWithWebIdentity`
  StringEquals `<issuer>:sub` condition).

The policy edits are pure document transformations (table-tested like
`plugin_iam_test.go:302`); the network edge is a two-method provider seam
with in-memory fakes. Like the JAX package, and unlike the reference's
`addBinding` (which appends a duplicate binding object on every apply,
`plugin_workload_identity.go:135-143`), the GCP transform merges into an
existing binding and does nothing when the member is already there, so
re-reconciles don't grow the policy.

The plugins plug into `controllers/profile.ProfileController(plugins=)`:
`apply` on every reconcile, `revoke` from the Profile's finalizer. The
controller-manager binary registers none, as JAX's registers none: cloud
IAM is a Python API.
"""

from __future__ import annotations

import copy
import re
from typing import Protocol

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound

# GCP constants (plugin_workload_identity.go:32-36).
KIND_WORKLOAD_IDENTITY = "WorkloadIdentity"
GCP_ANNOTATION_KEY = "iam.gke.io/gcp-service-account"
GCP_SA_SUFFIX = ".iam.gserviceaccount.com"
WORKLOAD_IDENTITY_ROLE = "roles/iam.workloadIdentityUser"

# AWS constants (plugin_iam.go:19-25).
KIND_AWS_IAM = "AwsIamForServiceAccount"
AWS_ANNOTATION_KEY = "eks.amazonaws.com/role-arn"
AWS_TRUST_SUBJECT = "system:serviceaccount:{namespace}:{name}"
AWS_DEFAULT_AUDIENCE = "sts.amazonaws.com"

EDITOR_SA = "default-editor"


class PluginError(Exception):
    pass


# -- GCP: pure policy transforms ------------------------------------------


def gcp_project_from_sa(gcp_sa: str) -> str:
    """Project id of a GSA email (`plugin_workload_identity.go:54-65`);
    raises on anything that is not `<name>@<project>.iam.gserviceaccount.com`."""
    if not gcp_sa.endswith(GCP_SA_SUFFIX):
        raise PluginError(f"{gcp_sa!r} is not a valid GCP service account")
    m = re.search(r"@(.+?)\.", gcp_sa)
    if m is None or "@" not in gcp_sa.removesuffix(GCP_SA_SUFFIX):
        raise PluginError(f"cannot extract project id from {gcp_sa!r}")
    return m.group(1)


def workload_identity_member(
    identity_project: str, namespace: str, ksa: str
) -> str:
    """The Workload Identity pool member for a KSA
    (`plugin_workload_identity.go:123`)."""
    return f"serviceAccount:{identity_project}.svc.id.goog[{namespace}/{ksa}]"


def add_workload_identity_binding(
    policy: dict, member: str
) -> tuple[dict, bool]:
    """Grant WORKLOAD_IDENTITY_ROLE to `member`. Returns (new policy,
    changed). Merges into an existing binding for the role and no-ops on
    a duplicate — idempotent re-apply keeps the policy fixed-point."""
    policy = copy.deepcopy(policy)
    bindings = policy.setdefault("bindings", [])
    for binding in bindings:
        if binding.get("role") == WORKLOAD_IDENTITY_ROLE:
            members = binding.setdefault("members", [])
            if member in members:
                return policy, False
            members.append(member)
            return policy, True
    bindings.append({"role": WORKLOAD_IDENTITY_ROLE, "members": [member]})
    return policy, True


def remove_workload_identity_binding(
    policy: dict, member: str
) -> tuple[dict, bool]:
    """Remove `member` from every WORKLOAD_IDENTITY_ROLE binding
    (`plugin_workload_identity.go:146-153`), dropping bindings that end
    up empty (GCP rejects member-less bindings on set)."""
    policy = copy.deepcopy(policy)
    changed = False
    kept = []
    for binding in policy.get("bindings", []):
        if (
            binding.get("role") == WORKLOAD_IDENTITY_ROLE
            and member in binding.get("members", [])
        ):
            changed = True
            binding["members"] = [
                m for m in binding["members"] if m != member
            ]
            if not binding["members"]:
                continue
        kept.append(binding)
    policy["bindings"] = kept
    return policy, changed


# -- AWS: pure trust-policy transforms ------------------------------------


def issuer_from_provider_arn(arn: str) -> str:
    """`arn:aws:iam::<acct>:oidc-provider/<issuer>` → `<issuer>`
    (`plugin_iam.go:241-243`)."""
    _, _, issuer = arn.partition("/")
    if not issuer:
        raise PluginError(f"no OIDC issuer in provider ARN {arn!r}")
    return issuer


def role_name_from_arn(arn: str) -> str:
    """`arn:aws:iam::<acct>:role/<name>` → `<name>` (`plugin_iam.go:245`)."""
    return arn.rsplit("/", 1)[-1]


def _trust_parts(doc: dict) -> tuple[str, str, list[str]]:
    """(provider ARN, issuer, current :sub identities) of the first
    statement — the reference operates only on Statement[0]
    (`plugin_iam.go:143`)."""
    statements = doc.get("Statement") or []
    if not statements:
        raise PluginError("trust policy has no statements")
    stmt = statements[0]
    provider = (stmt.get("Principal") or {}).get("Federated", "")
    if not provider:
        raise PluginError("statement 0 has no federated principal")
    issuer = issuer_from_provider_arn(provider)
    subs = (stmt.get("Condition") or {}).get("StringEquals", {}).get(
        f"{issuer}:sub", []
    )
    if isinstance(subs, str):
        subs = [subs]
    return provider, issuer, list(subs)


def _make_trust_policy(
    provider: str, issuer: str, subs: list[str]
) -> dict:
    """Canonical trust document (`MakeAssumeRoleWithWebIdentityPolicyDocument`,
    `plugin_iam.go:250-267`); the :sub condition is omitted when empty
    (an empty JSON list would break policy validation, plugin_iam.go:213)."""
    condition: dict = {
        "StringEquals": {f"{issuer}:aud": [AWS_DEFAULT_AUDIENCE]}
    }
    if subs:
        condition["StringEquals"][f"{issuer}:sub"] = subs
    return {
        "Version": "2012-10-17",
        "Statement": [
            {
                "Effect": "Allow",
                "Action": "sts:AssumeRoleWithWebIdentity",
                "Principal": {"Federated": provider},
                "Condition": condition,
            }
        ],
    }


def add_trusted_service_account(
    doc: dict, namespace: str, name: str
) -> tuple[dict, bool]:
    """Add `system:serviceaccount:<ns>:<name>` to the trust policy's
    `:sub` condition (`addServiceAccountInAssumeRolePolicy`,
    plugin_iam.go:127-178). No-op when already trusted."""
    provider, issuer, subs = _trust_parts(doc)
    subject = AWS_TRUST_SUBJECT.format(namespace=namespace, name=name)
    if subject in subs:
        return copy.deepcopy(doc), False
    return _make_trust_policy(provider, issuer, subs + [subject]), True


def remove_trusted_service_account(
    doc: dict, namespace: str, name: str
) -> tuple[dict, bool]:
    """Remove the KSA's subject (`removeServiceAccountInAssumeRolePolicy`,
    plugin_iam.go:180-238)."""
    provider, issuer, subs = _trust_parts(doc)
    subject = AWS_TRUST_SUBJECT.format(namespace=namespace, name=name)
    if subject not in subs:
        return copy.deepcopy(doc), False
    remaining = [s for s in subs if s != subject]
    return _make_trust_policy(provider, issuer, remaining), True


# -- provider seams ---------------------------------------------------------


class GcpIamClient(Protocol):
    """The two calls the GCP plugin makes
    (`plugin_workload_identity.go:112-131`)."""

    def get_iam_policy(self, sa_resource: str) -> dict: ...

    def set_iam_policy(self, sa_resource: str, policy: dict) -> None: ...


class AwsIamClient(Protocol):
    """The two calls the AWS plugin makes (`plugin_iam.go:77-101`)."""

    def get_trust_policy(self, role_name: str) -> dict: ...

    def update_trust_policy(self, role_name: str, doc: dict) -> None: ...


class InMemoryGcpIam:
    """CI / platform-in-a-box provider: policies keyed by SA resource."""

    def __init__(self, policies: dict[str, dict] | None = None):
        self.policies = {
            k: copy.deepcopy(v) for k, v in (policies or {}).items()
        }
        self.set_calls = 0

    def get_iam_policy(self, sa_resource: str) -> dict:
        return copy.deepcopy(
            self.policies.setdefault(sa_resource, {"bindings": []})
        )

    def set_iam_policy(self, sa_resource: str, policy: dict) -> None:
        self.set_calls += 1
        self.policies[sa_resource] = copy.deepcopy(policy)


class InMemoryAwsIam:
    """CI / platform-in-a-box provider: trust policies keyed by role name."""

    def __init__(self, roles: dict[str, dict] | None = None):
        self.roles = {k: copy.deepcopy(v) for k, v in (roles or {}).items()}
        self.update_calls = 0

    def get_trust_policy(self, role_name: str) -> dict:
        if role_name not in self.roles:
            raise PluginError(f"no such role {role_name!r}")
        return copy.deepcopy(self.roles[role_name])

    def update_trust_policy(self, role_name: str, doc: dict) -> None:
        self.update_calls += 1
        self.roles[role_name] = copy.deepcopy(doc)


# -- plugins (Profile controller `Plugin` protocol) -------------------------


def _plugin_specs(profile: Resource, kind: str) -> list[dict]:
    return [
        p.get("spec", {})
        for p in profile.spec.get("plugins", [])
        if p.get("kind") == kind
    ]


def _annotate_editor_sa(
    api: FakeApiServer, namespace: str, key: str, value: str | None
) -> None:
    """Set (or, with value=None, remove) an annotation on the namespace's
    default-editor KSA (`patchAnnotation`, both reference plugins)."""
    try:
        sa = api.get("ServiceAccount", EDITOR_SA, namespace).thaw()
    except NotFound:
        raise PluginError(
            f"ServiceAccount {namespace}/{EDITOR_SA} not found — plugins "
            "run after the profile's SAs exist"
        )
    if value is None:
        if key not in sa.metadata.annotations:
            return
        del sa.metadata.annotations[key]
    else:
        if sa.metadata.annotations.get(key) == value:
            return
        sa.metadata.annotations[key] = value
    api.update(sa)


class WorkloadIdentityPlugin:
    """GCP Workload Identity: KSA annotation + GSA policy binding."""

    name = KIND_WORKLOAD_IDENTITY

    def __init__(self, iam: GcpIamClient):
        self.iam = iam

    def _targets(self, profile: Resource) -> list[tuple[str, str]]:
        """(sa_resource, member) per configured GSA."""
        out = []
        namespace = profile.metadata.name
        for spec in _plugin_specs(profile, KIND_WORKLOAD_IDENTITY):
            gcp_sa = spec.get("gcpServiceAccount", "")
            project = gcp_project_from_sa(gcp_sa)
            out.append(
                (
                    f"projects/{project}/serviceAccounts/{gcp_sa}",
                    workload_identity_member(project, namespace, EDITOR_SA),
                )
            )
        return out

    def apply(self, api: FakeApiServer, profile: Resource) -> None:
        namespace = profile.metadata.name
        for spec in _plugin_specs(profile, KIND_WORKLOAD_IDENTITY):
            _annotate_editor_sa(
                api, namespace, GCP_ANNOTATION_KEY,
                spec.get("gcpServiceAccount", ""),
            )
        for sa_resource, member in self._targets(profile):
            policy, changed = add_workload_identity_binding(
                self.iam.get_iam_policy(sa_resource), member
            )
            if changed:
                self.iam.set_iam_policy(sa_resource, policy)

    def revoke(self, api: FakeApiServer, profile: Resource) -> None:
        # Reference parity: revoke removes only the IAM binding
        # (`RevokePlugin` :156-160); the KSA annotation dies with the
        # namespace cascade.
        for sa_resource, member in self._targets(profile):
            policy, changed = remove_workload_identity_binding(
                self.iam.get_iam_policy(sa_resource), member
            )
            if changed:
                self.iam.set_iam_policy(sa_resource, policy)


class AwsIamPlugin:
    """AWS IAM-for-ServiceAccount: KSA annotation + role trust policy."""

    name = KIND_AWS_IAM

    def __init__(self, iam: AwsIamClient):
        self.iam = iam

    def apply(self, api: FakeApiServer, profile: Resource) -> None:
        namespace = profile.metadata.name
        for spec in _plugin_specs(profile, KIND_AWS_IAM):
            role_arn = spec.get("awsIamRole", "")
            _annotate_editor_sa(api, namespace, AWS_ANNOTATION_KEY, role_arn)
            role = role_name_from_arn(role_arn)
            doc, changed = add_trusted_service_account(
                self.iam.get_trust_policy(role), namespace, EDITOR_SA
            )
            if changed:
                self.iam.update_trust_policy(role, doc)

    def revoke(self, api: FakeApiServer, profile: Resource) -> None:
        namespace = profile.metadata.name
        for spec in _plugin_specs(profile, KIND_AWS_IAM):
            role_arn = spec.get("awsIamRole", "")
            # AWS parity: revoke removes the annotation too
            # (`RevokePlugin` plugin_iam.go:42-49). The SA may already be
            # gone if the namespace cascade ran first — that's fine.
            try:
                _annotate_editor_sa(
                    api, namespace, AWS_ANNOTATION_KEY, None
                )
            except PluginError:
                pass
            role = role_name_from_arn(role_arn)
            doc, changed = remove_trusted_service_account(
                self.iam.get_trust_policy(role), namespace, EDITOR_SA
            )
            if changed:
                self.iam.update_trust_policy(role, doc)
