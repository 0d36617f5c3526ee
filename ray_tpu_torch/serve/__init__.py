"""ray_tpu_torch.serve — the port's serving path: ``LlamaGenerator`` on the
continuous batching engine. The Serve control plane (deployments, replicas,
``build_llama_app``) is not ported yet."""
