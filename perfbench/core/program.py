'''
The bridge to the program: the port's SeekerConfig of a configuration file. Every key of
the file's 'model' entry reaches the program, as a field of SeekerConfig or as a width
checked against the program's own (its depth preset gives D and the heads; its MLP is
4 x D; its LayerNorm eps is 1e-6), so that no key of a configuration is dropped unseen.
'''

import dataclasses
from typing import Dict, Optional

# The model keys that are not fields of SeekerConfig: widths the program derives.
DERIVED = ('embed_dim', 'num_heads', 'mlp_dim', 'ln_eps')
# The training keys that are fields of SeekerConfig.
TRAIN_FIELDS = ('drop_path_rate', 'remat', 'remat_policy', 'attention_bwd')
PROGRAM_LN_EPS = 1e-6


def seeker_config(model: Dict, train: Optional[Dict], compute_dtype):
    '''The port's SeekerConfig of a configuration's 'model' (and 'train') entries. Raises
    ValueError where a key is unknown to the program or where the program would give other
    widths than the file.'''
    from tcow_tpu_torch.models import timesformer as tsf
    from tcow_tpu_torch.models.mask_tracker import SeekerConfig
    fields = {f.name for f in dataclasses.fields(SeekerConfig)}
    unknown = sorted(set(model) - fields - set(DERIVED))
    if unknown:
        raise ValueError(f'model keys the program has no field for: {unknown}')
    preset = tsf.DEPTH_PRESETS.get(model['network_depth'])
    if preset != (model['embed_dim'], model['num_heads']) \
            or model['mlp_dim'] != 4 * model['embed_dim'] \
            or model.get('ln_eps', PROGRAM_LN_EPS) != PROGRAM_LN_EPS:
        raise ValueError(f"the program's depth-{model['network_depth']} preset {preset} "
                         f"(MLP 4 x D, LayerNorm eps {PROGRAM_LN_EPS}) does not give the "
                         f"configuration's widths")
    kw = {k: v for k, v in model.items() if k in fields}
    if train is not None:
        kw.update({k: train[k] for k in TRAIN_FIELDS})
    return SeekerConfig(pretrained=False, compute_dtype=compute_dtype, **kw)
