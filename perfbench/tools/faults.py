'''
Faults planted in the program underneath a run, for the readings a limit is set from
(tools/readings.py) and for the tests that see `correct` come out false. The harness's
timed path is left as it is: each fault replaces a function of the port while the context
lasts.

  unchanged   the training step returns its state unchanged (and a loss and a gradient
              norm of 0);
  half_batch  the training step, or the request, takes the first half of the batch's
              clips alone, the mean taken over them;
  loss_scale  the training step's backward runs on twice the loss;
  altered     the first clip's mask logits of a request's answer are moved by 1.
'''

import contextlib

import torch

FAULTS = ('unchanged', 'half_batch', 'loss_scale', 'altered')


def _half(batch):
    B = batch['query_inds'].shape[0]
    return {k: (v[:B // 2] if getattr(v, 'ndim', 0) > 0 else v) for k, v in batch.items()}


@contextlib.contextmanager
def _replaced(owner, name: str, make):
    '''owner.name replaced by make(the original) while the context lasts.'''
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _unchanged_step(make_train_step):
    def make(cfg, *args, **kwargs):
        def train_step(state, batch, progress):
            zero = torch.tensor(0.0)
            return state, {'total_seeker': zero, 'skipped_nonfinite': zero, 'grad_norm': zero}
        return train_step
    return make


def _half_step(make_train_step):
    def make(cfg, *args, **kwargs):
        step = make_train_step(cfg, *args, **kwargs)
        return lambda state, batch, progress: step(state, _half(batch), progress)
    return make


def _half_request(run_plugin):
    def run(self, rgb, query, target, *args, **kwargs):
        h = rgb.shape[0] // 2
        return run_plugin(self, rgb[:h], query[:h], target[:h], *args, **kwargs)
    return run


def _altered_request(run_plugin):
    def run(self, *args, **kwargs):
        results = run_plugin(self, *args, **kwargs)
        results[0][0]['output_mask'] = results[0][0]['output_mask'] + 1.0
        return results
    return run


@contextlib.contextmanager
def planted(fault: str):
    '''The program with `fault` (one of FAULTS) planted while the context lasts.'''
    from tcow_tpu_torch.evaluation.inference import InferenceEngine
    from tcow_tpu_torch.train import step as step_lib
    with contextlib.ExitStack() as stack:
        if fault == 'unchanged':
            stack.enter_context(_replaced(step_lib, 'make_train_step', _unchanged_step))
        elif fault == 'half_batch':
            stack.enter_context(_replaced(step_lib, 'make_train_step', _half_step))
            stack.enter_context(_replaced(InferenceEngine, 'run_plugin', _half_request))
        elif fault == 'loss_scale':
            stack.enter_context(_replaced(step_lib, 'backward_loss',
                                          lambda f: lambda loss, mesh: f(2.0 * loss, mesh)))
        elif fault == 'altered':
            stack.enter_context(_replaced(InferenceEngine, 'run_plugin', _altered_request))
        else:
            raise ValueError(f'no fault {fault!r}: {FAULTS}')
        yield
