from repro_torch.kernels.ivf_topk.ops import (probe_scan, scan_topk_probe,
                                              scan_topk_quantized, shared_scan)
