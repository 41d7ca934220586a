"""Host-side utilities of the port: corpus BLEU, preemption, the
cross-process consistency check, the TensorBoard writer and the training
loop's profiler and step timer."""
