"""The kernels' least time over their device time, %."""
from vvcbench.readers import kernels_roofline as read  # noqa: F401
