"""nvJPEG's decode states reused before their decode has run, on the card:
the committed Motion-JPEG clip's frames decoded back to back by
decode.NvJpeg (each state waits on an event recorded after its last
decode) and by the pool without that wait (a state back in the pool as
soon as nvjpegDecode returns), each held to one-at-a-time decodes with the
card synchronised after each. With the card idle and behind ~0.1 s of
queued matmuls, on the legacy default stream and on a side stream, and
through VideoReader threaded and unthreaded. Run on a CUDA machine from
the repo root:

    python tests/torch_nvjpeg_reuse.py

It prints, for each pool and case, how many frames differ.
"""

from __future__ import annotations

import ctypes
import os
import queue
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vision_kit_tpu_torch.data import decode  # noqa: E402
from vision_kit_tpu_torch.utils import video_bench as vb  # noqa: E402
from vision_kit_tpu_torch.utils.readers import VideoReader  # noqa: E402


class Unwaited(decode.NvJpeg):
    """The pool without the wait: a state goes back when nvjpegDecode
    returns, its decode's work on the stream perhaps not yet run. Colour
    JPEGs only; `sync_each` synchronises the stream after each decode."""

    sync_each = False

    def _state(self):
        try:
            return self._states.get_nowait()
        except queue.Empty:
            state = ctypes.c_void_p()
            assert self.lib.vk_jpeg_state_create(self.handle, ctypes.byref(state)) == 0
            return state

    def decode(self, data, ncomp):
        c = [ctypes.c_int() for _ in range(4)]
        assert self.lib.vk_jpeg_info(self.handle, data, len(data),
                                     *(ctypes.byref(x) for x in c)) == 0
        w, h = c[2].value, c[3].value
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=self.device)
        stream = torch.cuda.current_stream(self.device)
        state = self._state()
        status = self.lib.vk_jpeg_decode(self.handle, state, data, len(data),
                                         out.data_ptr(), 3 * w,
                                         decode.NVJPEG_OUTPUT_RGBI, stream.cuda_stream)
        self._states.put(state)
        assert status == 0, status
        if self.sync_each:
            stream.synchronize()
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    clip = os.path.join(vb.VIDEO_SAMPLES, vb.MJPEG_MKV)
    jpegs = vb.movie_frames(clip)
    print(torch.cuda.get_device_name(0), "torch", torch.__version__, "CUDA",
          torch.version.cuda, "nvJPEG", decode.nvjpeg_version(), flush=True)
    decode._nvjpeg[dev] = Unwaited(dev)
    ref = []
    for data in jpegs:
        ref.append(decode.decode_to(data, dev))
        torch.cuda.synchronize()
    big = torch.ones(8192, 8192, device=dev)
    side = torch.cuda.Stream(dev)

    def loop(stream, busy):
        with torch.cuda.stream(stream or torch.cuda.current_stream(dev)):
            for _ in range(6 if busy else 0):
                big @ big
            return [decode.decode_to(data, dev) for data in jpegs]

    def reader(threaded):
        r = VideoReader(clip, use_thread=threaded, device=dev)
        out = [frame for ok, frame in r if ok]
        r.stop()
        return out

    cases = (("default stream, card busy", lambda: loop(None, True), 10),
             ("side stream, card busy", lambda: loop(side, True), 10),
             ("side stream, card idle", lambda: loop(side, False), 50),
             ("VideoReader threaded", lambda: reader(True), 50),
             ("VideoReader unthreaded", lambda: reader(False), 50))
    for name, pool, sync_each in (("unwaited", Unwaited, False),
                                  ("unwaited, stream synchronised after each", Unwaited, True),
                                  ("NvJpeg (waits on the state's event)", decode.NvJpeg, False)):
        Unwaited.sync_each = sync_each
        decode._nvjpeg[dev] = pool(dev)
        print(f"{name}:", flush=True)
        for case, run, reps in cases:
            bad, which, t0 = 0, set(), time.perf_counter()
            for _ in range(reps):
                outs = run()
                torch.cuda.synchronize()
                for i, (got, want) in enumerate(zip(outs, ref)):
                    if not torch.equal(got, want):
                        bad += 1
                        which.add(i)
            print(f"  {case}: {bad} of {reps * len(jpegs)} frames differ (frames "
                  f"{sorted(which)}), {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
