"""Hardware constants (the paper's GPUs, the scheduler's inputs, and the
H100 the port runs on) and the roofline: a step's work counted as it runs
(``op_cost``), its terms on the H100 (``analysis``) and their table
(``report``)."""
