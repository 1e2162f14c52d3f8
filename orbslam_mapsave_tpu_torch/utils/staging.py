"""Host arrays to the card through pinned staging buffers.

A copy from pageable host memory to the card blocks the host until it is
done, and ATen converts the array's dtype on the host before it copies.
`Staging` instead copies each array into a pinned host buffer of its own
dtype and sends it to the card without blocking, so the sensor's u8 image
and f16 depth cross at their own widths and are converted on the card.
"""

from __future__ import annotations

import torch


class Staging:
    """Copies host arrays (numpy or CPU tensors) to one device.

    On a CUDA device each named slot owns a pinned host buffer and, unless
    the caller gives `out`, a device buffer. A call copies the array into
    the pinned buffer on the host and from there to the device on the
    current stream without blocking; an event recorded after that copy is
    waited on before the pinned buffer is written again, so a host that
    runs ahead never overwrites a copy in flight. The slot's device buffer
    is reused by its next call: kernels queued before that call still read
    this frame's data, by stream order. A tensor already on a CUDA device is
    copied device to device into `out`, or returned as it is. On any other
    device a call is a plain `.to`.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._slots: dict[str, tuple] = {}  # name -> (pinned, device buffer, event)

    def __call__(self, name: str, x, out: torch.Tensor | None = None) -> torch.Tensor:
        src = torch.as_tensor(x)
        if self.device.type != "cuda" or src.device.type != "cpu":
            if out is None:
                return src.to(self.device)
            return out.copy_(src)
        dtype = src.dtype if out is None else out.dtype
        slot = self._slots.get(name)
        if slot is None or slot[0].shape != src.shape or slot[0].dtype != dtype:
            pinned = torch.empty(src.shape, dtype=dtype, pin_memory=True)
            buf = None if out is not None else torch.empty_like(pinned, device=self.device)
            slot = self._slots[name] = (pinned, buf, torch.cuda.Event())
        else:
            slot[2].synchronize()  # the last copy out of the pinned buffer is done
        pinned, buf, done = slot
        pinned.copy_(src)
        dst = buf if out is None else out
        dst.copy_(pinned, non_blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        return dst
