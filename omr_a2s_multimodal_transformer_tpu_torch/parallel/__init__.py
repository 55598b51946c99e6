"""Data and tensor parallelism over ``torch.distributed`` (port of
``omr_a2s_multimodal_transformer_tpu/parallel/``): ``multihost`` starts the
process group, ``mesh`` lays the processes out as a ('data', 'model') grid
and holds the sharding rules, ``collectives`` the differentiable
collectives the sharded model calls."""
