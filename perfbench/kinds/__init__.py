"""The runners of the traffic kinds, one module each, named as the `kind` of
a traffic mix's data file."""
