"""Multi-rank rendering and training over torch.distributed (port of
cudatracerlib_tpu/parallel/): process bring-up and rank meshes in
`distributed`, the sharded render, train step and PPM pass in `shard`."""
