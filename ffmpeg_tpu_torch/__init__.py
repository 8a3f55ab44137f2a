"""ffmpeg_tpu_torch: the VVC (H.266) decoder in PyTorch and CUDA.

The port of `ffmpeg_tpu` (JAX) to one NVIDIA H100.  It decodes I, P and
B slices of 8/10/12-bit 4:2:0 and 4:0:0 streams with every coding tool
the JAX package decodes (DMVR, LMCS, ALF/CC-ALF, ISP, 64-sample
transform blocks with CTU-128, explicit scaling lists among them):
native CABAC parse -> dequant/inverse transform -> inter prediction
against the DPB and reconstruction (two hand-written CUDA kernels on the
card) -> LMCS inverse -> deblock -> SAO -> ALF -> packed frames.  4:2:2
and 4:4:4 streams, which the JAX package refuses too, are refused with
NotImplementedError.

    from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
    for frame in VVCDecoder(device="cuda").decode(data):
        frame.md5()
"""
