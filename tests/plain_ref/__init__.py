"""Plain references of the port's paths, written from the LIA tools'
semantics and importing nothing of either package."""
