"""Multi-tenant campaign scheduling over one device batch.

The counterpart of wtf_tpu/tenancy: one card serving *different*
campaigns concurrently, the shape of multi-tenant inference serving —
heterogeneous requests batched through one step engine, jobs placed onto
lane ranges, preemption through durable state (the campaign checkpoint
format is already placement-free).

Two tiers:

  heterogeneous batch axis (image.py + the runner's tenant routing)
      per-lane base-image ids index a STACKED image table — every
      tenant's snapshot packed into one page store with one padded
      pfn->slot row per tenant — and the decode cache keys entries by
      (tenant, rip), so demo_tlv + demo_kernel + demo_pe lanes share ONE
      batch: the fused step kernel (csrc/fused_step.cu) picks each lane's
      frame-table row and tags its probe key with the lane's tenant.
      Tenant identity is pure DATA (the `MemImage.tenant` selector).

  scheduler tier (sched.py / loop.py / state.py / backend.py)
      campaigns as jobs (`python -m wtf_tpu_torch sched` + jobs.json)
      placed onto lane ranges of the batch, with priorities and lane
      quotas; preemption checkpoints a tenant at a batch boundary
      (the resume format per tenant, coverage bit-planes remapped to
      tenant-local entry indices so they are placement-free), hands its
      lanes to another job, and resumes later bit-identically.
      Telemetry lands under per-tenant `tenant.<name>.*` namespaces with
      tenant-tagged JSONL events.

The mesh-sharded tenancy batch of the JAX package is not part of the
port (`create_tenancy_backend(mesh_devices=...)` raises).
"""

from wtf_tpu_torch.tenancy.image import (  # noqa: F401
    BatchState, build_batch_state, stack_images,
)
from wtf_tpu_torch.tenancy.backend import (  # noqa: F401
    TenancyBackend, TenantSpec, create_tenancy_backend,
)
from wtf_tpu_torch.tenancy.loop import (  # noqa: F401
    MultiTenantLoop, TenantRuntime,
)
from wtf_tpu_torch.tenancy.sched import Job, Scheduler, load_jobs  # noqa: F401
