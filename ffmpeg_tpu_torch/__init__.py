"""ffmpeg_tpu_torch: the VVC (H.266) decoder in PyTorch and CUDA.

The port of `ffmpeg_tpu` (JAX) to one NVIDIA H100.  It decodes I, P and
B slices of 8/10/12-bit 4:2:0 and 4:0:0 streams: native CABAC parse ->
dequant/inverse transform -> inter prediction against the DPB and
reconstruction (two hand-written CUDA kernels on the card) -> deblock
-> SAO -> packed frames.  Streams with tools the port does not cover
yet (DMVR, LMCS, ALF, ISP, TB-64, scaling lists, 4:2:2/4:4:4) are
refused with NotImplementedError.

    from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
    for frame in VVCDecoder(device="cuda").decode(data):
        frame.md5()
"""
