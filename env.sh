# Environment setup for lbm_tpu (the reference's env.sh analogue).
# On a single-GPU host nothing is usually needed — jax discovers the card.
# Device override (the reference's OCL_DEVICE analogue):
#   export LBM_DEVICE=0
# Keep compiled programs across runs (default: .jax_cache/ in the checkout):
#   export JAX_COMPILATION_CACHE_DIR=/path/to/cache
# For a run spanning several processes, set the JAX distributed variables
# before running with --multihost, e.g.:
#   export JAX_COORDINATOR_ADDRESS=localhost:8476
#   export JAX_NUM_PROCESSES=<n> JAX_PROCESS_ID=<i>
