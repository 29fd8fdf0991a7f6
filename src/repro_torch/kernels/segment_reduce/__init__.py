from repro_torch.kernels.segment_reduce.ops import segment_sum, segment_sum_csr
