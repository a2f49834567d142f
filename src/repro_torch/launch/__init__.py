"""Entry points and analysis on the card: the LM training driver
(``train_lm``), work models and roofline terms (``roofline``), the
engine's dry run (``dryrun_engine``), the one-shot obs report
(``obs_report``), and the LM stack's meshes (``mesh``), rules
(``rules``), cells (``specs``), per-op step counts (``op_analysis``),
dry run on the fake backend (``dryrun``) and its optimized sweep
(``sweep_opt``)."""
