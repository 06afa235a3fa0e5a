"""Distributed training over ``torch.distributed`` (port of
``dpsvm_tpu/parallel/``): one process a device, NCCL between CUDA ranks
and gloo between CPU ranks.

* ``mesh``      the data mesh (group, rank, world size, device) and its
                collectives;
* ``multihost`` process-group lifecycle, identity and the local launcher
                (``launch_local``, the counterpart of ``mpirun -np P``);
* ``dist_smo``  the sharded SMO pair (``train_distributed``);
* ``dist_decomp`` the sharded decomposition, kernel B on every rank
                (``train_distributed_decomp``).
"""
