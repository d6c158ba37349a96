"""Share of the profiled slice in which no operation ran on the device.
Percent."""


def read(view):
    return view.idle_percent()
