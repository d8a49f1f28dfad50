"""karpenter-core provisioning solver on PyTorch and CUDA (NVIDIA Hopper).

A port of ``karpenter_core_tpu`` (the JAX package beside this one, which
stays the reference). Module paths mirror the reference's, so each
counterpart is easy to find; the port keeps its own copy of every host
module it needs and imports nothing of the reference package.

It solves one provisioning ``Solve()``: pods with requests,
``nodeSelector``, node affinity, tolerations, topology spread, pod affinity
and anti-affinity, host ports, PVC-backed volumes under CSINode attach
limits, daemonset overhead, several weighted provisioners with limits,
existing nodes and relaxation, against a live cluster when given a kube
client (``kube/client.py``) and a ``state/cluster.Cluster``. It screens
consolidation candidate subsets in batches (``TorchSolver.replan_screen``,
``solver/replan.py``) for the multi- and single-node consolidation
deprovisioners (``controllers/deprovisioning/consolidation.py``), and runs
the deprovisioning chain (Expiration, Drift, Emptiness and the
consolidations, ``controllers/deprovisioning/controller.py``), executing
its Commands through the node lifecycle: replacement launches, the
machine, node and termination controllers, cordon, drain and termination
(``controllers/{machine,node,termination}``).

Entry points: ``karpenter_core_tpu_torch.solver.torch_solver.TorchSolver``,
the deprovisioners' ``compute_command`` and
``DeprovisioningController.reconcile``, driven synchronously by
``testing.ControlLoop``.
It runs on the CUDA card by default and raises when none is present unless
the caller asks for ``device="cpu"``.
"""
