"""Traffic mixes (``<mix>.json``), the one generator that reads them, and
the loops (``loops/<loop>.py``) and length distributions
(``lengths/<dist>.py``) a mix names."""
