"""The instances the configurations name, each built from its published
generator as plain arrays: ``build(**args)`` returns A, P, row_lb,
row_ub, col_lb, col_ub (infinite where a side is absent) and, where the
instance has them, the ordering cone's generators Y and the duality
parameter c.  These are frozen copies, so the benchmark does not move
when the program's own copies of the examples do."""
