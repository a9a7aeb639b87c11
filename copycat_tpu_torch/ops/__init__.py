"""Device plane of the port: the quorum-tally kernel, the resource apply
kernels and the consensus step."""
