from uurg_torch.utils.profiling import StepTimer, timed, trace
