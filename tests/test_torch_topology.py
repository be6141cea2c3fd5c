"""The port's GPU topology vocabulary and contract against the JAX
package's TPU one (``kubeflow_tpu/api/topology.py``).

- ``h100-N`` names one NVLink domain (one node) of N GPUs, N in 1, 2, 4,
  8; any other count, another generation and every TPU name are refused,
  a TPU name with a message that names the ``h100-N`` form.
- One pod a GPU: ``render_contracts(h100-8, 2 slices)`` gives the 16
  contracts the JAX package renders for ``v5e-32`` (8 hosts a slice) over
  2 slices: the same coordinator, process count, process-id order and
  slice ids, pod for pod.
- ``to_env``/``from_env`` round trip; the device count comes from the
  parsed topology; the bootstrap refuses a TPU topology in the env.
"""

import pytest

from kubeflow_tpu_torch.api import topology as T
from kubeflow_tpu_torch.runtime import bootstrap


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_h100_slices_are_the_gpus_of_one_node(n):
    topo = T.parse_topology(f"H100-{n} ")
    assert topo.name == f"h100-{n}" and topo.num_gpus == n
    assert topo.pods_per_slice == n
    assert topo.hbm_gib == 80 * n
    assert topo.generation.gpus_per_node == 8
    assert topo.to_dict() == {"name": f"h100-{n}", "generation": "h100",
                              "numGpus": n, "podsPerSlice": n,
                              "product": "NVIDIA-H100-80GB-HBM3"}


@pytest.mark.parametrize("name,match", [
    ("v5e-8", "TPU topology.*h100-N"), ("v4-32", "TPU topology.*h100-N"),
    ("v5p-8", "TPU topology"), ("h100-3", "3-GPU slices"),
    ("h100-16", "16-GPU slices"), ("h100-0", "0-GPU slices"),
    ("a100-8", "unknown GPU generation"), ("h100", "invalid GPU topology"),
    ("", "invalid GPU topology"), ("h100-8x2", "invalid GPU topology")])
def test_other_names_are_refused(name, match):
    with pytest.raises(ValueError, match=match):
        T.parse_topology(name)


def test_contracts_match_the_jax_packages_host_order():
    from kubeflow_tpu.api import topology as J
    jax_c = J.render_contracts("job", "ns", J.parse_topology("v5e-32"),
                               num_slices=2)
    ours = T.render_contracts("job", "ns", T.parse_topology("h100-8"),
                              num_slices=2)
    assert len(ours) == len(jax_c) == 16
    assert J.parse_topology("v5e-32").num_hosts == 8
    for a, b in zip(ours, jax_c):
        assert (a.coordinator_address, a.num_processes, a.process_id,
                a.num_slices, a.slice_id) == \
            (b.coordinator_address, b.num_processes, b.process_id,
             b.num_slices, b.slice_id)
        assert a.num_devices == 16 and a.topology == "h100-8"
    assert [c.process_id for c in ours] == list(range(16))
    assert ours[0].coordinator_address == "job-worker-0-0.job-workers.ns:8476"


def test_env_round_trip_and_device_count():
    (c,) = T.render_contracts("j", "ns", T.parse_topology("h100-1"),
                              port=9000, headless_service="svc")
    env = c.to_env()
    assert env == {"KFTPU_COORDINATOR_ADDRESS": "j-worker-0-0.svc.ns:9000",
                   "KFTPU_NUM_PROCESSES": "1", "KFTPU_PROCESS_ID": "0",
                   "KFTPU_TOPOLOGY": "h100-1", "KFTPU_NUM_SLICES": "1",
                   "KFTPU_SLICE_ID": "0"}
    assert T.TopologyContract.from_env(env) == c
    last = T.render_contracts("j", "ns", T.parse_topology("h100-4"),
                              num_slices=3)[-1]
    back = T.TopologyContract.from_env(last.to_env())
    assert back == last
    assert (back.process_id, back.slice_id, back.num_devices) == (11, 2, 12)


def test_bootstrap_refuses_a_tpu_topology():
    env = {"KFTPU_TOPOLOGY": "v5e-8", "KFTPU_NUM_PROCESSES": "1",
           "KFTPU_PROCESS_ID": "0",
           "KFTPU_COORDINATOR_ADDRESS": "localhost:1"}
    with pytest.raises(ValueError, match="h100-N"):
        bootstrap.initialize(env, device="cpu")
