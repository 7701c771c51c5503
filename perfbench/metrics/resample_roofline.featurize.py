"""resample_roofline.featurize: kernel B1 (resize + normalize) against
its roofline in the traced window.  The least time is the bytes the
resize needs at the calls' shapes (every uint8 input pixel read once,
every float32 output value written once) at the HBM rate; the kernel
time is the device time of the kernels named below.  Their FLOPs (a few
taps a value) lie far under the byte bound."""
from perfbench.harness.device import HBM_BYTES_PER_S

NAME = "resample_roofline.featurize"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernel B1"
MOVES = "images_per_s"
KERNELS = ("affine_resample",)


def min_bytes(h, w, c, h_out, w_out, in_item=1, out_item=4):
    """Bytes one image's resize and normalize needs."""
    return h * w * c * in_item + h_out * w_out * c * out_item


def read(view):
    if view.trace is None:
        return None
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    if not launches or seconds <= 0:
        return None
    h_out, w_out = view.config["image_size"]
    nbytes = sum(n * min_bytes(h, w, c, h_out, w_out)
                 for rec in view.traced
                 for (h, w, c), n in rec["shapes"].items())
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
