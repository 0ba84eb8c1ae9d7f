"""The plain versions of the port's fused stages (its kernels K2-K11), as
torch ops in the operation order the kernels keep: the reference route
runs these and nothing else."""
