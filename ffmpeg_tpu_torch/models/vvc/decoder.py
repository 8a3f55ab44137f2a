"""Top-level VVC decoder: annex-B bytes -> decoded frames, on one device.

Mirrors the reference session model (avcodec send/receive,
vvcdec.c:868-891): feed access units, receive frames in output order.
Host parsing is native (libvvc_host) on a thread pool; each frame is
one run of the frame program (pipeline.py) on the session's device.

  - The DPB holds each frame's padded int32 planes as device tensors.
  - Each frame's output is packed on the device into one planar-YCbCr
    buffer; a group of frames comes back with non-blocking copies into
    one pinned host buffer and a single stream synchronisation.
  - Frames are produced ahead of the consumer, so device work of frame
    n+1 overlaps the host parse and fetch of earlier frames.
  - Each frame's residual error word (pipeline.frame_program) is read
    before the frame, or any frame decoded after it, is handed out: with
    the group's fetch, or (fetch=False) through a pinned copy and an
    event; a word that names rows out of range raises RuntimeError.

The session runs on `device` ("cuda" unless the caller passes "cpu");
a CUDA session without a CUDA device raises, it never falls back.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ...ops.transform import raise_on_error
from ...utils import trace
from ...utils.log import get_logger
from .host import HostDecoder
from .inputs import _padded_plane_shapes, check_supported, has_dmvr
from .pipeline import prepare_frame, refine_dmvr, submit_frame

log = get_logger("vvc.decoder")

# frames fetched per device->host transfer; also the dispatch-ahead depth
FETCH_BATCH = 8
# numbers the sessions of the process, for the trace's frame identifiers
_SESSIONS = itertools.count()


@dataclass
class DecoderConfig:
    """Runtime decoder options (the AVOption analog; the reference maps
    thread_count to its executor width, vvcdec.c:937-954)."""
    host_threads: int = 4      # parallel host CABAC parse lanes
    fetch_batch: int = FETCH_BATCH  # frames per device->host transfer
    errors: str = "contain"    # "contain": log + skip bad AUs;
    #                            "raise": propagate (strict/test mode).
    #                            Unsupported streams raise either way.


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A packed CPU tensor as the frame's sample array (the int16
    pack of >8-bit frames carries uint16 sample bytes)."""
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


class Frame:
    """A decoded frame; `buf` is the planar-YCbCr packed pixel buffer
    (uint8, or uint16 little-endian for >8-bit).  `buf` may still be a
    device tensor (decode(fetch=False)); it is fetched on first host
    access."""

    def __init__(self, poc, buf, width, height, bit_depth):
        self.poc = poc
        self.buf = buf
        self.width = width
        self.height = height
        self.bit_depth = bit_depth

    def _host_buf(self) -> np.ndarray:
        if isinstance(self.buf, torch.Tensor):
            self.buf = _host_view(self.buf.cpu())
        return self.buf

    @property
    def planes(self) -> list:
        """[Y, Cb, Cr] numpy views into the packed buffer ([Y] for
        4:0:0 monochrome frames)."""
        buf, w, h = self._host_buf(), self.width, self.height
        if buf.size == w * h:  # monochrome
            return [buf.reshape(h, w)]
        cs = (w // 2) * (h // 2)
        return [buf[:w * h].reshape(h, w),
                buf[w * h:w * h + cs].reshape(h // 2, w // 2),
                buf[w * h + cs:].reshape(h // 2, w // 2)]

    def tobytes(self) -> bytes:
        return self._host_buf().tobytes()

    def md5(self) -> str:
        # planar YCbCr bytes == the packed buffer, in order
        return hashlib.md5(self.tobytes()).hexdigest()


def _fetch_group(packed_list, errs=()):
    """Bring a group of packed frame buffers to the host: CUDA buffers
    go with non-blocking copies into one pinned buffer and a single
    synchronisation of each device's current stream.  errs: (label,
    error word) pairs of frames (pipeline.frame_program's "err"), fetched
    with the buffers and read before any buffer is returned: a word that
    names rows out of range raises RuntimeError with its label."""
    errs = list(errs)
    with trace.span("fetch"):
        tensors = [e for _, e in errs] + list(packed_list)
        if all(t.device.type == "cpu" for t in tensors):
            views = tensors
        else:
            nbytes = [t.numel() * t.element_size() for t in tensors]
            host = torch.empty(sum(nbytes), dtype=torch.uint8,
                               pin_memory=True)
            views, off = [], 0
            for t, nb in zip(tensors, nbytes):
                dst = host[off:off + nb].view(t.dtype)
                dst.copy_(t, non_blocking=True)
                views.append(dst)
                off += nb
            for dev in {t.device for t in tensors}:
                torch.cuda.current_stream(dev).synchronize()
        for (label, _), word in zip(errs, views):
            raise_on_error(int(word[0]), f" ({label})")
        return [_host_view(v) for v in views[len(errs):]]


class _ErrorWords:
    """The residual error words of a session's frames not yet read, in
    decode order: (decode index, POC, word on the device, pinned host
    copy, event after the copy); the copy and event only for frames that
    are handed out unfetched (decode(fetch=False)) from a CUDA device."""

    def __init__(self):
        self.pending = []

    def add(self, idx, poc, err, copy):
        host = ev = None
        if copy and err.device.type == "cuda":
            host = torch.empty(1, dtype=torch.int32, pin_memory=True)
            host.copy_(err, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        self.pending.append((idx, poc, err, host, ev))

    def labelled(self):
        """The pending words as _fetch_group's errs, all now read."""
        out = [(f"POC {poc}", err) for _, poc, err, _, _ in self.pending]
        self.pending.clear()
        return out

    def check(self, upto):
        """Read the words of the frames decoded up to index `upto` (a
        frame handed out and every frame it may reference); raises
        RuntimeError on the first that names rows out of range."""
        keep = []
        for entry in self.pending:
            idx, poc, err, host, ev = entry
            if idx > upto:
                keep.append(entry)
                continue
            if ev is not None:
                ev.synchronize()
                word = int(host[0])
            else:
                word = int(err.item())
            raise_on_error(word, f" (POC {poc})")
        self.pending = keep


_PARAM_NAL_TYPES = (12, 13, 14, 15, 16, 17, 18)  # OPI/DCI/VPS/SPS/PPS/APS


def resolve_device(device) -> torch.device:
    """The session device; a CUDA request without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to decode on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class VVCDecoder:
    """Streaming decoder for annex-B VVC (I, P and B slices).

    Host CABAC parsing runs on a thread pool (the native call releases
    the GIL): entropy decode of every access unit is independent once
    its parameter sets are known.  This mirrors the reference's
    frame-parallel entropy threading (vvc_thread.c PARSE stage).
    """

    def __init__(self, device="cuda", host_threads: int | None = None,
                 config: DecoderConfig | None = None) -> None:
        import dataclasses
        import queue
        from concurrent.futures import ThreadPoolExecutor

        from .host import ColStore

        self.device = resolve_device(device)
        cfg = config or DecoderConfig()
        if host_threads is not None:
            cfg = dataclasses.replace(cfg, host_threads=host_threads)
        self.config = cfg
        self._colstore = ColStore()  # session-scoped TMVP exchange
        self._hosts: queue.Queue = queue.Queue()
        for _ in range(cfg.host_threads):
            self._hosts.put(HostDecoder(self._colstore))
        self._exec = ThreadPoolExecutor(max_workers=cfg.host_threads)
        self._parse_ahead = 2 * cfg.host_threads
        # a frame's trace identifier: (session, access units handed to the
        # lanes before it), shared by its spans on every thread
        self._trace_session = next(_SESSIONS)
        self._n_aus = 0
        self._dpb: dict[int, list] = {}  # poc -> [Y, Cb, Cr] device planes
        self._epoch_base = 0  # monotone across decode() calls (TMVP keys)
        # open-GOP / gradual-recovery output state (decode_recovery_flag
        # + decode_recovery_poc, vvc_ps.c:745-762; suppression rule
        # vvc_refs.c:178): a CRA/GDR that STARTS decoding (after
        # construction or flush) suppresses output of its RASL leading
        # pictures / pre-recovery-point pictures
        self._last_eos = True
        self._no_out_before_rec = False
        self._recovery_poc = None  # GDR recovery point (None = recovered)

    def flush(self) -> None:
        """Drop all inter-frame stream state (avcodec_flush_buffers /
        vvc_decode_flush analog, vvcdec.c:894-907).  After a flush,
        decoding must resume at an IRAP access unit."""
        from .host import ColStore

        self._dpb.clear()
        self._colstore = ColStore()
        self._epoch_base = 0
        self._last_eos = True
        self._no_out_before_rec = False
        self._recovery_poc = None
        # re-bind the pooled host parsers to the fresh colstore
        while not self._hosts.empty():
            self._hosts.get_nowait()
        for _ in range(self.config.host_threads):
            self._hosts.put(HostDecoder(self._colstore))

    def _gray_planes(self, fs):
        """A mid-gray reference for a missing one (missing-ref recovery,
        vvc_refs.c:316-347: generate_missing_ref)."""
        sy, sc = _padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)
        gray = 1 << (fs.bit_depth - 1)
        shapes = [sy] if fs.chroma_format_idc == 0 else [sy, sc, sc]
        return [torch.full(s, gray, dtype=torch.int32, device=self.device)
                for s in shapes]

    def _parse_au(self, au: bytes, epoch: int, fid):
        """Worker-thread frame stage: native CABAC parse (releases the
        GIL) + the numpy host inputs (pipeline.prepare_frame, which
        refuses streams outside the port's slices).  A frame with DMVR
        units returns (fs, None): its unit controls need the refined
        MVs, which need the reference planes, so the main thread runs
        the refinement and builds its inputs afterwards.  fid: the
        frame's trace identifier."""
        with trace.frame(fid):
            hd = self._hosts.get()
            try:
                with trace.span("host_parse"):
                    fs = hd.decode_au(au, epoch)
            finally:
                self._hosts.put(hd)
            if fs is None:
                return None
            if has_dmvr(fs):
                check_supported(fs)  # refuse before any device work
                return fs, None
            return fs, prepare_frame(fs)

    def _split_aus(self, data: bytes):
        """[(nal_type, epoch, au_bytes)] where each AU is self-contained:
        the parameter sets seen so far are prepended, so any worker can
        parse any AU without shared state.  `epoch` counts IDRs so the
        TMVP store can disambiguate restarted POCs under parse-ahead."""
        from ...bitstream.bits import split_annexb_raw

        params: list[bytes] = []
        cur: list[bytes] = []
        cur_slice_type: int | None = None
        cur_has_ph = False
        aus = []
        base = self._epoch_base
        epoch = base - 1

        def close():
            nonlocal cur, cur_slice_type, cur_has_ph, epoch
            if cur_slice_type is not None:
                if cur_slice_type in (7, 8):  # IDR resets POC sequence
                    epoch += 1
                aus.append((cur_slice_type, max(epoch, base),
                            b"".join(params) + b"".join(cur)))
            cur, cur_slice_type, cur_has_ph = [], None, False

        for t, _layer, _tid, raw in split_annexb_raw(data):
            if t in _PARAM_NAL_TYPES:
                params.append(raw)
                continue
            if t == 19:  # PH NAL opens a new AU (multi-slice pictures)
                close()
                cur.append(raw)
                cur_has_ph = True
                continue
            cur.append(raw)
            if t <= 10:  # coded slice
                if cur_slice_type is None:
                    cur_slice_type = t
                if not cur_has_ph:
                    # in-slice picture header => exactly one slice/AU
                    close()
        close()
        self._epoch_base = epoch + 1
        return aus

    def decode(self, data: bytes, fetch: bool = True):
        """Decode a buffer holding one or more access units; yields Frames
        in output order (DPB bumping bounded by the reorder depth).

        With fetch=False, frames are yielded as soon as their frame
        program is queued, with device-resident pixel buffers (fetched
        lazily on access) — the `-f null` mode.

        The main thread's trace spans: parse_wait (on a lane's parse),
        submit (queuing the frame program), and out_wait (on a frame's
        error word before it is handed out, fetch=False) or fetch.
        """
        from collections import deque

        aus = self._split_aus(data)
        window: list = []  # Frames queued on the device, not yet fetched
        words = _ErrorWords()  # their residual error words, and others'
        n_submitted = 0

        def flush():
            if not window:
                return []
            bufs = _fetch_group([f.buf for f in window], words.labelled())
            for f, b in zip(window, bufs):
                f.buf = b
            out = list(window)
            window.clear()
            return out

        # (nal_type, epoch, trace frame id, future), decode order
        inflight: deque = deque()
        next_submit = 0
        pending_out: list = []
        reorder_depth = 0

        def top_up():
            nonlocal next_submit
            while (next_submit < len(aus)
                   and len(inflight) < self._parse_ahead):
                nal_type, epoch, au = aus[next_submit]
                fid = (self._trace_session, self._n_aus)
                inflight.append((nal_type, epoch, fid, self._exec.submit(
                    self._parse_au, au, epoch, fid)))
                next_submit += 1
                self._n_aus += 1

        def emit(frame):
            if not fetch:
                with trace.frame(frame._trace_id), trace.span("out_wait"):
                    words.check(frame._decode_idx)
                return [frame]
            window.append(frame)
            if len(window) >= self.config.fetch_batch:
                return flush()
            return []

        def bump(all_of_them=False):
            out = []
            limit = 0 if all_of_them else reorder_depth
            while len(pending_out) > limit:
                pending_out.sort(key=lambda f: f.poc)
                out.extend(emit(pending_out.pop(0)))
            return out

        contain = self.config.errors == "contain"
        top_up()
        first = True
        while inflight:
            nal_type, epoch, fid, fut = inflight.popleft()
            is_idr = nal_type in (7, 8)
            try:
                with trace.frame(fid), trace.span("parse_wait"):
                    parsed = fut.result()
            except NotImplementedError:
                raise  # outside the port: never contained, never guessed
            except Exception as e:
                # per-frame error containment (vvc_thread.c:605-617 /
                # vvcdec.c:795-798: a failed frame is dropped, the
                # session keeps decoding)
                if not contain:
                    raise
                log.error("dropping undecodable access unit: %s", e)
                top_up()
                continue
            top_up()
            if parsed is None:
                continue
            fs, host_inp = parsed
            if fs.slice_type != 2:
                needed = set(fs.ref_pocs[0]) | set(fs.ref_pocs[1])
                missing = needed - set(self._dpb)
                if missing and not contain:
                    raise RuntimeError(f"missing reference frames {missing}")
                for poc in missing:
                    log.warning("poc %d: missing reference %d, "
                                "synthesizing gray", fs.poc, poc)
                    self._dpb[poc] = self._gray_planes(fs)
            if host_inp is None:
                # DMVR, in decode order and before waiting on a later
                # frame's parse: the search on the card against the DPB,
                # then the refined motion to the native side, which
                # publishes the frame's collocated motion and rebuilds its
                # unit controls
                with trace.frame(fid):
                    refine_dmvr(fs, self._colstore, epoch, self._dpb,
                                self.device)
                    host_inp = prepare_frame(fs)
            if is_idr:
                if not first:
                    yield from bump(all_of_them=True)
                self._dpb.clear()
            first = False
            reorder_depth = fs.max_num_reorder
            with trace.frame(fid), trace.span("submit"):
                packed, planes, err = submit_frame(host_inp, fs,
                                                   self.device, self._dpb)
                words.add(n_submitted, fs.poc, err, copy=not fetch)
            n_submitted += 1
            self._dpb[fs.poc] = planes
            # RPS-driven DPB lifetime (spec 8.3.2 / vvc_refs.c:196-294)
            listed = set(fs.ref_pocs[0]) | set(fs.ref_pocs[1])
            if listed:
                for poc in [p for p in self._dpb
                            if p != fs.poc and p not in listed]:
                    del self._dpb[poc]
            log.debug("decoded poc %d (%dx%d), dpb=%d", fs.poc, fs.width,
                      fs.height, len(self._dpb))
            # recovery-output model (vvc_ps.c:745-762, vvc_refs.c:178):
            # IDR clears it; CRA/GDR only suppress when they start the
            # CLVS (session start / post-flush)
            if is_idr:
                self._no_out_before_rec = False
                self._recovery_poc = None
            elif nal_type in (9, 10):  # CRA / GDR
                self._no_out_before_rec = self._last_eos
                if self._no_out_before_rec and nal_type == 10:
                    self._recovery_poc = fs.poc + fs.recovery_poc_cnt
            self._last_eos = False
            recovered = (self._recovery_poc is None
                         or self._recovery_poc <= fs.poc)
            if recovered:
                self._recovery_poc = None
            suppress = self._no_out_before_rec and (nal_type == 3
                                                    or not recovered)
            if not suppress:
                cl, cr2, ct, cb2 = fs.crop
                frame = Frame(poc=fs.poc, buf=packed,
                              width=fs.width - cl - cr2,
                              height=fs.height - ct - cb2,
                              bit_depth=fs.bit_depth)
                frame._decode_idx = n_submitted - 1
                frame._trace_id = fid
                pending_out.append(frame)
            yield from bump()
        yield from bump(all_of_them=True)
        yield from flush()


def decode_file(path: str, device="cuda"):
    with open(path, "rb") as f:
        data = f.read()
    dec = VVCDecoder(device=device)
    yield from dec.decode(data)
