"""Matmul FLOPs of the policy and value MLPs at their published widths
(biases and activations left out)."""


def widths(cfg: dict, obs_sizes: dict, action_size: int):
  """(policy widths, value widths), input to output."""
  nf = cfg['ppo']['network_factory']
  policy = ([obs_sizes[nf['policy_obs_key']]]
            + list(nf['policy_hidden_layer_sizes']) + [2 * action_size])
  value = ([obs_sizes[nf['value_obs_key']]]
           + list(nf['value_hidden_layer_sizes']) + [1])
  return policy, value


def forward(sizes) -> int:
  """FLOPs of one row through the MLP: 2·in·out a layer."""
  return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def forward_backward(sizes) -> int:
  """FLOPs of one row forward and backward: the forward, the weights'
  gradient of every layer, the input's gradient of all but the first."""
  pairs = list(zip(sizes[:-1], sizes[1:]))
  return forward(sizes) + sum(2 * a * b for a, b in pairs) + sum(
      2 * a * b for a, b in pairs[1:])
