"""SPMD multi-device execution: mesh, distributed shuffle, skew handling.

Replaces the reference's pthread fan-out + NUMA-local task queues
(parallel_radix_join.c:1484-1696, task_queue.h) with a device mesh: relations
hash-partitioned across devices, histogram exchange via psum, partition
shuffle via all_to_all, bloom pre-filter applied before the exchange.
"""
