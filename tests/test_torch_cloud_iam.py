"""The port's cloud IAM profile plugins (`controllers/cloud_iam.py`)
against the JAX package's.

- JAX's own tests/test_cloud_iam.py runs against the port, every case,
  its imports pointed at the port.
- A parity table: the same Profiles and starting policy documents go
  through JAX's and the port's plugins, each behind its own package's
  ProfileController, and give equal GCP policies, AWS trust policies
  and KSA annotations after the first apply, a second apply and the
  revoke on deletion.
- A Profile with a `WorkloadIdentity` plugin through the port's
  ProfileController: the binding is there while the Profile lives and
  gone once the finalizer has run and the store removed the Profile and
  drained its namespace.
"""

import copy
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api import new_resource as j_new_resource
from kubeflow_tpu.controllers import cloud_iam as j_iam
from kubeflow_tpu.controllers.profile import ProfileController as JProfileController
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api import new_resource
from kubeflow_tpu_torch.controllers import cloud_iam
from kubeflow_tpu_torch.controllers.profile import KIND, ProfileController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu_torch.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_cloud_iam")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_cloud_iam_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 13


def test_the_port_keeps_jax_names_and_constants():
    for name in ("KIND_WORKLOAD_IDENTITY", "GCP_ANNOTATION_KEY", "GCP_SA_SUFFIX",
                 "WORKLOAD_IDENTITY_ROLE", "KIND_AWS_IAM", "AWS_ANNOTATION_KEY",
                 "AWS_TRUST_SUBJECT", "AWS_DEFAULT_AUDIENCE", "EDITOR_SA"):
        assert getattr(cloud_iam, name) == getattr(j_iam, name), name


GSA = "kf-user@my-proj.iam.gserviceaccount.com"
GSA_2 = "etl@data-proj.iam.gserviceaccount.com"
SA_RESOURCE = f"projects/my-proj/serviceAccounts/{GSA}"
ISSUER = "oidc.eks.us-west-2.amazonaws.com/id/DEADBEEF"
PROVIDER_ARN = f"arn:aws:iam::123456789012:oidc-provider/{ISSUER}"
ROLE_ARN = "arn:aws:iam::123456789012:role/kf-user-role"


def _trust(subs):
    cond = {"StringEquals": {f"{ISSUER}:aud": ["sts.amazonaws.com"]}}
    if subs is not None:
        cond["StringEquals"][f"{ISSUER}:sub"] = subs
    return {"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Action": "sts:AssumeRoleWithWebIdentity",
        "Principal": {"Federated": PROVIDER_ARN}, "Condition": cond}]}


WI = {"kind": "WorkloadIdentity", "spec": {"gcpServiceAccount": GSA}}
WI_2 = {"kind": "WorkloadIdentity", "spec": {"gcpServiceAccount": GSA_2}}
AWS = {"kind": "AwsIamForServiceAccount", "spec": {"awsIamRole": ROLE_ARN}}
OTHER_MEMBER = "serviceAccount:my-proj.svc.id.goog[other/default-editor]"

# (plugins, starting GCP policies, starting AWS roles)
CASES = {
    "gcp-empty": ([WI], {}, {}),
    "gcp-merge-into-role": (
        [WI], {SA_RESOURCE: {"etag": "e1", "bindings": [
            {"role": "roles/iam.workloadIdentityUser", "members": [OTHER_MEMBER]},
            {"role": "roles/viewer", "members": ["user:x"]}]}}, {}),
    "gcp-two-accounts": ([WI, WI_2], {}, {}),
    "aws-no-sub": ([AWS], {}, {"kf-user-role": _trust(None)}),
    "aws-keeps-others": (
        [AWS], {}, {"kf-user-role": _trust(["system:serviceaccount:other:default-editor"])}),
    "both": ([WI, AWS], {}, {"kf-user-role": _trust([])}),
}


def _run(pkg: str, plugins, policies, roles) -> list:
    """The profile "team-a" with `plugins` through one package's
    controller and plugins: (GCP policies, AWS roles, the editor KSA's
    annotations) after the first apply, a second apply and deletion."""
    if pkg == "jax":
        api, iam, make, ctl_cls = JFakeApiServer(), j_iam, j_new_resource, JProfileController
    else:
        api, iam, make, ctl_cls = FakeApiServer(), cloud_iam, new_resource, ProfileController
    gcp, aws = iam.InMemoryGcpIam(policies), iam.InMemoryAwsIam(roles)
    ctl = ctl_cls(api, plugins={
        iam.KIND_WORKLOAD_IDENTITY: iam.WorkloadIdentityPlugin(gcp),
        iam.KIND_AWS_IAM: iam.AwsIamPlugin(aws)})
    api.create(make(KIND, "team-a", "default", spec={
        "owner": {"kind": "User", "name": "alice@example.com"},
        "plugins": copy.deepcopy(plugins)}))

    def snap():
        try:
            ann = dict(api.get("ServiceAccount", "default-editor", "team-a").metadata.annotations)
        except Exception:  # drained with the namespace
            ann = None
        return (copy.deepcopy(gcp.policies), copy.deepcopy(aws.roles), ann,
                gcp.set_calls, aws.update_calls)

    out = []
    ctl.controller.run_until_idle()
    out.append(snap())
    ctl.controller.enqueue(("default", "team-a"))
    ctl.controller.run_until_idle()
    out.append(snap())
    api.delete(KIND, "team-a")
    ctl.controller.run_until_idle()
    out.append(snap())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plugins_give_jax_policies_annotations_and_writes(case):
    plugins, policies, roles = CASES[case]
    got = _run("port", plugins, policies, roles)
    want = _run("jax", plugins, policies, roles)
    assert got == want
    # The second apply wrote nothing (JAX's fixed point), the revoke did.
    assert got[1][3:] == got[0][3:]


def test_workload_identity_binding_lives_and_dies_with_the_profile():
    api = FakeApiServer()
    gcp = cloud_iam.InMemoryGcpIam()
    ctl = ProfileController(api, plugins={
        cloud_iam.KIND_WORKLOAD_IDENTITY: cloud_iam.WorkloadIdentityPlugin(gcp)})
    api.create(new_resource(KIND, "team-a", "default", spec={
        "owner": {"kind": "User", "name": "alice@example.com"}, "plugins": [WI]}))
    ctl.controller.run_until_idle()
    member = cloud_iam.workload_identity_member("my-proj", "team-a", "default-editor")
    assert gcp.policies[SA_RESOURCE]["bindings"] == [
        {"role": cloud_iam.WORKLOAD_IDENTITY_ROLE, "members": [member]}]
    profile = api.get(KIND, "team-a")
    assert "profile-finalizer.kubeflow-tpu.org" in profile.metadata.finalizers
    assert api.get("ServiceAccount", "default-editor", "team-a").metadata.annotations[
        cloud_iam.GCP_ANNOTATION_KEY] == GSA

    api.delete(KIND, "team-a")
    ctl.controller.run_until_idle()
    assert gcp.policies[SA_RESOURCE]["bindings"] == []
    with pytest.raises(NotFound):
        api.get(KIND, "team-a")
    with pytest.raises(NotFound):
        api.get("ServiceAccount", "default-editor", "team-a")
