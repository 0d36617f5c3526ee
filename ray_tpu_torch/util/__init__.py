"""ray_tpu_torch.util — the utilities the port's runtime reaches: metrics,
scheduling strategies and placement groups (copied from ``ray_tpu/util``),
and ``ray_tpu_torch.util.collective``, the collective API across actors
(host and NCCL backends)."""
