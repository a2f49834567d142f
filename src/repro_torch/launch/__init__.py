"""Entry points and analysis on the card: the LM training driver
(``train_lm``), work models and roofline terms (``roofline``), the
engine's dry run (``dryrun_engine``) and the one-shot obs report
(``obs_report``)."""
