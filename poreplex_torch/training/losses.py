"""Training losses and metrics.

Weighted categorical crossentropy and accuracy with a class-confusion cost
matrix, the semantics of upstream poreplex's custom Keras objects
(poreplex/keras_wrap.py:48-94) as poreplex-tpu's ``training/losses.py``
computes them: each sample is weighted by
``cost_mat[true_class, predicted_class]``.

The weight indexes the cost matrix by the argmax of the prediction, so it
carries no gradient, as the one-hot of an argmax carries none in JAX.
``torch.clamp`` passes the whole gradient at a probability exactly on a
bound, where ``jnp.clip`` passes half (``tests/test_torch_training.py``);
elsewhere the two agree.
"""

import torch
import torch.nn.functional as F


def sample_weights(y_true_onehot, y_pred_probs, cost_mat):
    """cost_mat[k, l] for a sample of true class k predicted as l
    (poreplex/keras_wrap.py:63-79)."""
    num_classes = cost_mat.shape[0]
    pred_onehot = F.one_hot(torch.argmax(y_pred_probs, dim=-1),
                            num_classes).to(cost_mat.dtype)
    return torch.einsum('nk,nl,kl->n', y_true_onehot, pred_onehot, cost_mat)


def weighted_categorical_crossentropy(y_true_onehot, y_pred_probs, cost_mat,
                                      eps=1e-7):
    probs = torch.clamp(y_pred_probs, eps, 1.0 - eps)
    ce = -torch.sum(y_true_onehot * torch.log(probs), dim=-1)
    w = sample_weights(y_true_onehot, y_pred_probs, cost_mat)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=eps)


def shard_weighted_categorical_crossentropy(y_true_onehot, y_pred_probs,
                                            cost_mat, all_reduce, eps=1e-7):
    """One rank's share of the global batch's weighted crossentropy: its
    rows' ``sum(ce * w)`` over the weight sum of the whole batch,
    ``all_reduce`` summing a tensor over the ranks. The shares sum to
    ``weighted_categorical_crossentropy`` of the whole batch; the mean of
    each rank's own weighted mean would not, whenever the ranks' weight
    sums differ. The weight sum is detached: the weights index the cost
    matrix by an argmax and carry no gradient."""
    probs = torch.clamp(y_pred_probs, eps, 1.0 - eps)
    ce = -torch.sum(y_true_onehot * torch.log(probs), dim=-1)
    w = sample_weights(y_true_onehot, y_pred_probs, cost_mat)
    total = all_reduce(torch.sum(w).detach())
    return torch.sum(ce * w) / torch.clamp(total, min=eps)


def weighted_categorical_accuracy(y_true_onehot, y_pred_probs, cost_mat):
    correct = (torch.argmax(y_true_onehot, -1) ==
               torch.argmax(y_pred_probs, -1)).to(y_pred_probs.dtype)
    w = sample_weights(y_true_onehot, y_pred_probs, cost_mat)
    return torch.sum(correct * w) / torch.clamp(torch.sum(w), min=1e-7)
