"""% of the traced window in which the device ran no operation while the
server's collector was busy (in a span of its own other than
``server.wait``): the part of ``device.idle.serve`` the host's work between
and around batches holds the card idle."""

from vtbench import inside


def read(run):
    return inside.idle_host_share(run)
