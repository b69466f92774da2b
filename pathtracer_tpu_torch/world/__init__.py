from pathtracer_tpu_torch.world.world import World, world_from_numpy  # noqa: F401
