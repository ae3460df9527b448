from legged_gym_tpu_torch.parallel.sharding import (EnvMesh, all_sum,
                                                    env_mesh,
                                                    init_multihost,
                                                    replicate, run_ranks,
                                                    shard_batch,
                                                    shard_env_state)

__all__ = ["EnvMesh", "all_sum", "env_mesh", "init_multihost", "replicate",
           "run_ranks", "shard_batch", "shard_env_state"]
