"""Operations and bytes of the program's work, counted from shapes, so that
they do not change with whatever implements the work."""
